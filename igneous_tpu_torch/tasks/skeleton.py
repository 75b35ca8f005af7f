"""Skeleton forge, merge and maintenance tasks.

The port's own copy of ``skel_dir_for``, ``border_targets``,
``SkeletonTask``, ``_merge_label``, ``UnshardedSkeletonMergeTask``,
``ShardedSkeletonMergeTask``, ``ShardedFromUnshardedSkeletonMergeTask``
and the ``@queueable`` functions ``TransferSkeletonFilesTask`` and
``DeleteSkeletonFilesTask`` from ``igneous_tpu/tasks/skeleton.py``. A
``SkeletonTask`` skeletonizes every label of its cutout (the task's box
plus a 1-voxel high-side overlap, so adjacent tasks share a boundary
plane), pins a vertex per label patch on every shared plane so that the
merge welds the pieces, and writes one ``<label>:<bbox>.sk`` fragment per
label (or, with ``sharded=True``, one ``<bbox>.frags`` container named by
the task's physical box) and a ``.spatial`` index file, byte-identical to
the JAX package's. The unsharded merge fuses each label's fragments and
writes ``<label>``; the sharded merge fuses every label of one shard from
the ``.frags`` files the spatial index names, in the order of their
sorted keys (which sets the bytes), and writes the shard file.

Where the JAX package runs the whole-cutout EDT and the renumbering on the
host, the port runs them on the device (``ops.skeletonize``); tracing,
encoding and upload stay on the host.

``dust_global`` masks the labels whose count in the layer's voxel-count
census (``tasks.stats``) is below ``dust_threshold`` and turns the local
dust off; ``fill_holes`` then closes cavities (``ops.morphology``), as in
the JAX package.

Graphene layers skeletonize the proofread roots as of ``timestamp`` (the
supervoxels mapped on the device, ``ops.graphene_ids``), or the labels of
a materialized ``root_ids_cloudpath`` layer. ``fix_autapses`` constrains
the trace to the chunk graph: the client's voxel connectivity graph
(computed on the device) severs touching supervoxels that share no edge,
and every graph component is traced; without graphene it raises
``ValueError``. ``cross_sectional_area`` adds each vertex's slice area
(``ops.cross_section``, host code on ``csrc/xsection.cpp``; the labels'
boxes come from the device), ``low_memory_csa`` reads each label's mask
from a ``CompressedLabels`` copy, and ``csa_repair_sec_per_label`` (-1
unlimited, 0 off, else a wall-clock budget a label) revisits the clipped
slices against a context download (``_repair_csa_contacts``), as the JAX
package does.

Stage timers (``telemetry``): download, graphene (the id maps), dust_global
(the device count and the host mask), fill_holes (with dilate and erode
from level 3), pins (the border pins: their planes' connected components
on the CPU, whose own stages ``ops.ccl`` records too), voxel_graph, h2d,
edt, labels, d2h, trace, cross_section, csa_repair, upload (encoding
included).
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..compressed import CompressedLabels
from ..device import get_device
from ..lib import Bbox, Vec
from ..mesh_io import FragMap
from ..ops import remap as fastremap
from ..ops.ccl import connected_components
from ..ops.cross_section import cross_sectional_area
from ..ops.dbscan import dbscan
from ..ops.graphene_ids import roots_on_device
from ..ops.mesh import label_bboxes, unique_on_device
from ..ops.morphology import fill_holes
from ..ops.skeletonize import TeasarParams, skeletonize
from ..queues.registry import RegisteredTask, queueable
from ..sharding import ShardingSpecification
from ..skeleton_io import Skeleton, postprocess
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles, scratch_compression
from ..volume import Volume
from .stats import globally_small_labels


def skel_dir_for(vol: Volume, skel_dir: Optional[str]) -> str:
  if skel_dir:
    return skel_dir
  if vol.info.get("skeletons"):
    return vol.info["skeletons"]
  raise ValueError("No skeleton directory configured in the info file")


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
  run here unchanged."""

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
    self.cloudpath = cloudpath
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.teasar_params = teasar_params or {}
    self.object_ids = list(object_ids) if object_ids else None
    self.mask_ids = list(mask_ids) if mask_ids else None
    self.dust_threshold = int(dust_threshold)
    self.dust_global = bool(dust_global)
    self.fill_missing = fill_missing
    self.sharded = bool(sharded)
    self.skel_dir = skel_dir
    self.spatial_index = spatial_index
    self.fix_borders = fix_borders
    # the hole-filling level of ops.morphology.fill_holes (0 off)
    self.fill_holes = int(fill_holes)
    self.fix_branching = bool(fix_branching)
    self.fix_avocados = bool(fix_avocados)
    # graphene only: constrain the trace to the chunk graph
    self.fix_autapses = bool(fix_autapses)
    self.cross_sectional_area = bool(cross_sectional_area)
    # moving-average window over the slice normals
    self.csa_smoothing_window = int(csa_smoothing_window)
    # a label's repair budget in seconds: -1 unlimited, 0 no repair
    self.csa_repair_sec_per_label = int(csa_repair_sec_per_label)
    self.low_memory_csa = bool(low_memory_csa)
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
    self.timestamp = timestamp
    # write the fragments and spatial cells under another path
    self.frag_path = frag_path
    # a materialized root-id layer, read instead of graphene lookups
    self.root_ids_cloudpath = root_ids_cloudpath

  def prepare_labels(self, vol: Volume):
    """Download, the object-id masks, the global dust and the hole fill:
    everything before the EDT. Returns (labels, cutout, core, bounds) or
    None for an empty core."""
    bounds = vol.meta.bounds(self.mip)
    core = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), bounds)
    if core.empty():
      return None
    # +1 overlap: adjacent tasks share their boundary plane
    cutout = Bbox.intersection(Bbox(core.minpt, core.maxpt + 1), bounds)
    if vol.graphene is not None and self.root_ids_cloudpath:
      roots_vol = Volume(
        self.root_ids_cloudpath, mip=self.mip,
        fill_missing=self.fill_missing, bounded=False,
      )
      with telemetry.stage("download"):
        labels = roots_vol.download(cutout)[..., 0]
    elif vol.graphene is not None:
      # the proofread roots as of the timestamp; the supervoxels are kept
      # for the autapse voxel graph, so the cutout is read once
      with telemetry.stage("download"):
        sv = vol.download(cutout)[..., 0]
      with telemetry.stage("graphene"):
        labels = roots_on_device(vol.graphene, sv, self.timestamp)
      self._graphene_sv = sv
    else:
      with telemetry.stage("download"):
        labels = vol.download(cutout)[..., 0]
    if self.object_ids:
      labels = fastremap.mask_except(labels, self.object_ids)
    if self.mask_ids:
      labels = fastremap.mask(labels, self.mask_ids)
    if self.dust_global and self.dust_threshold:
      with telemetry.stage("dust_global"):
        labels = self._apply_global_dust(labels)
    if self.fill_holes:
      # cavities distort the EDT and spawn spurious loops
      labels = fill_holes(labels, level=self.fill_holes)
    return labels, cutout, core, bounds

  def _apply_global_dust(self, labels: np.ndarray) -> np.ndarray:
    uniq = unique_on_device(labels, get_device())[0]
    small = globally_small_labels(
      self.cloudpath, self.mip, uniq, self.dust_threshold
    )
    return fastremap.mask(labels, small) if small else labels

  @property
  def local_dust(self) -> int:
    """The per-cutout dust threshold: off when the global census dusts."""
    return 0 if self.dust_global and self.dust_threshold else self.dust_threshold

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
    vol = Volume(
      self.cloudpath, mip=self.mip, fill_missing=self.fill_missing,
      bounded=False,
    )
    prepared = _prepared if _prepared is not None else self.prepare_labels(vol)
    if prepared is None:
      return
    labels, cutout, core, bounds = prepared
    prepared = _prepared = None
    with telemetry.stage("pins"):
      targets = self.targets(labels, cutout, core, bounds)
    voxel_graph = None
    if self.fix_autapses and vol.graphene is None:
      raise ValueError("fix_autapses requires a graphene:// volume")
    if self.fix_autapses:
      sv = getattr(self, "_graphene_sv", None)
      if sv is None:  # prepared elsewhere (a batched runner)
        with telemetry.stage("download"):
          sv = vol.download(cutout)[..., 0]
      else:
        self._graphene_sv = None
      with telemetry.stage("voxel_graph"):
        voxel_graph = vol.graphene.voxel_connectivity_graph(
          sv, 26, self.timestamp,
          # the chunk-grid placement, for clients that shade graph-chunk
          # boundaries: the cutout's global offset at this mip and the
          # mip -> base scale
          offset=tuple(int(v) for v in cutout.minpt),
          downsample_ratio=tuple(
            int(v) for v in vol.meta.downsample_ratio(self.mip)
          ),
        )
      del sv
    self._graphene_sv = None
    skels = skeletonize(
      labels,
      anisotropy=tuple(float(v) for v in vol.resolution),
      params=TeasarParams.from_dict(self.teasar_params),
      offset=tuple(float(v) for v in cutout.minpt),
      dust_threshold=self.local_dust,
      extra_targets_per_label=targets,
      parallel=self.parallel,
      edt_field=_edt_field,
      voxel_graph=voxel_graph,
      fix_branching=self.fix_branching,
      fix_avocados=self.fix_avocados,
    )
    del voxel_graph

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

    if self.cross_sectional_area:
      with telemetry.stage("cross_section"):
        self._cross_sections(vol, skels, labels, cutout)
      del labels
      if self.csa_repair_sec_per_label != 0:
        with telemetry.stage("csa_repair"):
          self._repair_csa_contacts(vol, skels, bounds)

    with telemetry.stage("upload"):
      self._upload(vol, skels, core)

  def _cross_sections(self, vol: Volume, skels, labels, cutout: Bbox) -> None:
    """Each skeleton's ``cross_sectional_area`` vertex attribute, measured
    on its label's mask cropped to the label's box plus a one-voxel shell
    (an object ending inside the cutout keeps a background border, so
    only contacts with the cutout flag as clipped, negative). With
    ``low_memory_csa`` the masks decode from a ``CompressedLabels`` copy
    one label at a time."""
    anis = tuple(float(v) for v in vol.resolution)
    minpt = np.asarray(cutout.minpt, np.float32)
    if self.low_memory_csa:
      comp = CompressedLabels(labels)
      for label, skel in skels.items():
        got = comp.mask(int(label), margin=1)
        if got is None:
          continue
        mask, lo = got
        skel.extra_attributes["cross_sectional_area"] = cross_sectional_area(
          mask, skel, anisotropy=anis,
          offset=tuple(minpt + np.asarray(lo, np.float32)),
          smoothing_window=self.csa_smoothing_window,
        )
      return
    boxes = label_bboxes(labels)
    for label, skel in skels.items():
      sl = boxes.get(int(label))
      if sl is None:
        continue
      grow = tuple(
        slice(max(s.start - 1, 0), min(s.stop + 1, labels.shape[a]))
        for a, s in enumerate(sl)
      )
      crop_off = np.asarray([g.start for g in grow], dtype=np.float32)
      skel.extra_attributes["cross_sectional_area"] = cross_sectional_area(
        labels[grow] == label, skel, anisotropy=anis,
        offset=tuple(minpt + crop_off),
        smoothing_window=self.csa_smoothing_window,
      )

  # the context margin of the cross-section contact repair (voxels)
  CSA_REPAIR_CONTEXT = 150

  def _repair_csa_contacts(self, vol: "Volume", skels, bounds: Bbox) -> None:
    """Revisit vertices whose slice was clipped by the cutout (negative
    areas): cluster them (DBSCAN), re-download each cluster's
    neighborhood with context, recompute, and overwrite where the larger
    view produced a clean slice. A positive budget is wall-clock seconds
    a label, so what it repairs depends on time, as in the JAX package."""
    import time as _time

    anis = np.asarray(vol.resolution, dtype=np.float32)
    ctx = self.CSA_REPAIR_CONTEXT
    eps = float(2 * ctx * anis.min())  # one download per nearby group
    budget = self.csa_repair_sec_per_label
    for label, skel in skels.items():
      deadline = _time.monotonic() + budget if budget > 0 else None
      areas = skel.extra_attributes.get("cross_sectional_area")
      if areas is None or not len(skel.vertices):
        continue
      # clipped slices carry -area; exactly -1.0 is the unrepairable
      # sentinel (vertex outside mask / zero tangent) — re-downloading
      # cannot fix those, so skip them
      bad = np.flatnonzero((areas < 0) & (areas != -1.0))
      if len(bad) == 0:
        continue
      clusters = dbscan(skel.vertices[bad], eps=eps, min_samples=1)
      for c in np.unique(clusters):
        if deadline is not None and _time.monotonic() > deadline:
          break  # per-label budget spent; remaining flags stay negative
        members = bad[clusters == c]
        vox = np.round(
          skel.vertices[members] / anis
        ).astype(np.int64)
        region = Bbox(vox.min(axis=0) - ctx, vox.max(axis=0) + ctx + 1)
        region = Bbox.intersection(region, bounds)
        if region.empty():
          continue
        if vol.graphene is not None:
          # the skeletons are keyed by proofread ROOT ids — a raw
          # download would yield supervoxels and an always-empty mask
          cut = vol.download(
            region, agglomerate=True, timestamp=self.timestamp
          )[..., 0]
        else:
          cut = vol.download(region)[..., 0]
        if self.fill_holes:
          # the mask semantics of the first pass, which measured filled
          # labels: an unfilled cavity would shrink repaired areas
          cut = fill_holes(cut, level=self.fill_holes)
        mask = np.ascontiguousarray(cut == label)
        vmask = np.zeros(len(skel.vertices), dtype=bool)
        vmask[members] = True
        repaired = cross_sectional_area(
          mask, skel, anisotropy=tuple(float(v) for v in anis),
          offset=tuple(float(v) for v in region.minpt),
          window=ctx, vertex_mask=vmask,
          smoothing_window=self.csa_smoothing_window,
        )
        # a clean (positive) recompute wins — but the full slice always
        # CONTAINS the clipped slice, so a repaired area below the
        # flagged lower bound means the repair view diverged (e.g. a
        # cavity that the original whole-cutout fill_holes closed but the
        # ±ctx crop leaves open at its border); reject those rather than
        # silently shrink. A still-negative recompute means the section
        # genuinely reaches the dataset boundary — keep whichever lower
        # bound is larger.
        m = members
        accept = (repaired[m] > 0) & (
          repaired[m] >= -areas[m] * (1.0 - 1e-6)
        )
        areas[m] = np.where(
          accept, repaired[m], np.minimum(areas[m], repaired[m])
        )
      skel.extra_attributes["cross_sectional_area"] = areas

  def _upload(self, vol: Volume, skels: Dict[int, Skeleton], core: Bbox) -> None:
    sdir = skel_dir_for(vol, self.skel_dir)
    cf = CloudFiles(self.frag_path or vol.cloudpath)
    res = np.asarray(vol.resolution, dtype=np.int64)
    # .frags and .spatial share the physical bbox name, so the merges map
    # spatial-index cells to fragment containers by rename alone
    physical = Bbox(core.minpt * res, core.maxpt * res)
    # fragments are intermediate: a merge task reads and deletes them, so
    # IGNEOUS_SCRATCH_COMPRESS picks their compression (unset: gzip for
    # .sk files, none for the .frags container)
    if self.sharded:
      cf.put(
        f"{sdir}/{physical.to_filename()}.frags",
        FragMap.tobytes({label: s.to_precomputed() for label, s in skels.items()}),
        compress=scratch_compression(None),
      )
    else:
      compress = scratch_compression("gzip")
      for label, s in skels.items():
        cf.put(f"{sdir}/{label}:{core.to_filename()}.sk", s.to_precomputed(),
               compress=compress)
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


class ShardedSkeletonMergeTask(RegisteredTask):
  """Stage 2 (sharded): fuse every label assigned to one shard file and
  synthesize it."""

  def __init__(
    self,
    cloudpath: str,
    shard_no: int,
    skel_dir: Optional[str] = None,
    dust_threshold: float = 4000.0,
    tick_threshold: float = 6000.0,
    max_cable_length: Optional[float] = None,
  ):
    self.cloudpath = cloudpath
    self.shard_no = int(shard_no)
    self.skel_dir = skel_dir
    self.dust_threshold = dust_threshold
    self.tick_threshold = tick_threshold
    self.max_cable_length = (
      float(max_cable_length) if max_cable_length is not None else None
    )

  def execute(self):
    vol = Volume(self.cloudpath)
    sdir = skel_dir_for(vol, self.skel_dir)
    cf = CloudFiles(vol.cloudpath)
    skel_info = cf.get_json(f"{sdir}/info") or {}
    spec = ShardingSpecification.from_dict(skel_info["sharding"])

    # labels for this shard: spatial-index census filtered by shard number
    si = SpatialIndex(cf, sdir)
    locations = si.file_locations_per_label()
    labels = np.array(sorted(locations.keys()), dtype=np.uint64)
    if len(labels) == 0:
      return
    mine = labels[spec.shard_number(labels) == self.shard_no]
    if len(mine) == 0:
      return

    # fetch fragments: .spatial cell file ↔ .frags container (same bbox)
    needed_files = sorted({
      f for lbl in mine for f in locations[int(lbl)]
    })
    # fetch containers concurrently; the sorted key order is kept, and it
    # is the merge's input order (so it sets the bytes)
    with ThreadPoolExecutor(max_workers=8) as ex:
      datas = list(ex.map(
        lambda k: cf.get(k.replace(".spatial", ".frags")), needed_files
      ))
    fragmaps = [FragMap.frombytes(d) for d in datas if d is not None]

    attrs = skel_info.get("vertex_attributes")
    out = {}
    for label in mine.tolist():
      pieces = []
      for fm in fragmaps:
        blob = fm.get(label)
        if blob is not None:
          pieces.append(Skeleton.from_precomputed(blob, vertex_attributes=attrs))
      if not pieces:
        continue
      merged = _merge_label(
        pieces, self.dust_threshold, self.tick_threshold,
        self.max_cable_length,
      )
      if not merged.empty:
        out[int(label)] = merged.to_precomputed()

    if out:
      files = spec.synthesize_shard_files(out)
      for filename, data in files.items():
        cf.put(f"{sdir}/{filename}", data, compress=None)


class ShardedFromUnshardedSkeletonMergeTask(RegisteredTask):
  """Re-pack finished unsharded skeletons into one shard file."""

  def __init__(
    self,
    cloudpath: str,
    shard_no: int,
    src_skel_dir: str,
    skel_dir: str,
    dest_cloudpath: "str | None" = None,
  ):
    self.cloudpath = cloudpath
    self.shard_no = int(shard_no)
    self.src_skel_dir = src_skel_dir
    self.skel_dir = skel_dir
    # write the shard into a different volume (`skeleton xfer --sharded`)
    self.dest_cloudpath = dest_cloudpath

  def execute(self):
    vol = Volume(self.cloudpath)
    cf = CloudFiles(vol.cloudpath)
    out_cf = CloudFiles(self.dest_cloudpath or self.cloudpath)
    skel_info = out_cf.get_json(f"{self.skel_dir}/info") or {}
    spec = ShardingSpecification.from_dict(skel_info["sharding"])

    labels = []
    for key in cf.list(f"{self.src_skel_dir}/"):
      name = key.split("/")[-1]
      if name.isdigit():  # finished skeletons are bare label files
        labels.append(int(name))
    labels = np.array(sorted(labels), dtype=np.uint64)
    if len(labels) == 0:
      return
    mine = labels[spec.shard_number(labels) == self.shard_no]

    out = {}
    for label in mine.tolist():
      data = cf.get(f"{self.src_skel_dir}/{label}")
      if data is not None:
        out[int(label)] = data
    if out:
      files = spec.synthesize_shard_files(out)
      for filename, data in files.items():
        out_cf.put(f"{self.skel_dir}/{filename}", data, compress=None)


@queueable
def TransferSkeletonFilesTask(
  src: str, dest: str, skel_dir: str, prefix: str = ""
):
  """Copy the stored files under ``<skel_dir>/<prefix>`` of ``src`` to
  ``dest`` as they are stored."""
  cf = CloudFiles(src)
  cf.transfer_to(dest, paths=list(cf.list(f"{skel_dir}/{prefix}")))


@queueable
def DeleteSkeletonFilesTask(cloudpath: str, skel_dir: str, prefix: str = ""):
  """Delete the files under ``<skel_dir>/<prefix>``."""
  cf = CloudFiles(cloudpath)
  cf.delete(list(cf.list(f"{skel_dir}/{prefix}")))
