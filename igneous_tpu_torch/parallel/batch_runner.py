"""Batched runners: many grid cells per device launch.

Counterpart of ``igneous_tpu/parallel/batch_runner.py``. Instead of one
task at a time, one host walks a layer's task grid, downloads K
same-shape cutouts on a thread pool, runs the pyramid for all K at once
on the card, and uploads every mip; the next batch's downloads run while
one batch computes, and a batch's chunk encodes are joined one batch
behind. Edge cells (clamped to other shapes) ride the paged pyramid
(``parallel.paged``); the per-task path stays only for factor chains the
page cannot tile. ``batched_ccl_faces`` and ``batched_skeleton_forge``
take the same pattern to CCL pass 1 and to the skeleton forge's EDT.

Chunk bytes are those of solo task execution: the same upload routine
writes the same pyramid.

Not ported: the JAX package's host-pool branches (its native C++ pooling,
CCL and EDT on CPU-only hosts); the port has no host kernels, and a CPU
caller gets the plain versions through the same route.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..downsample_scales import DEFAULT_FACTOR, compute_factors
from ..lib import Bbox, Vec, chunk_bboxes
from ..ops import pooling
from ..task_creation.common import get_bounds
from ..tasks.image import DownsampleTask
from ..volume import Volume
from .executor import cached_chunk_executor, to_host


def device_pyramid_batch(executor, imgs):
  """K same-shape (x, y, z[, c]) cutouts -> per-mip (K, c, z, y, x) numpy
  batches from one ``executor.run`` (a ``planes=1`` ChunkExecutor): each
  cutout is copied into its slot of the batch on the card (no stack on
  the host). uint64 labels ride as they are: the mode kernel compares
  64-bit words."""
  dev = executor.device
  works = [pooling._work_array(img, executor.method) for img in imgs]
  with telemetry.stage("h2d"):
    first = works[0].transpose(3, 2, 1, 0)
    x = torch.empty((len(works),) + first.shape, dtype=torch.from_numpy(first).dtype, device=dev)
    for k, w in enumerate(works):
      x[k].copy_(torch.from_numpy(w.transpose(3, 2, 1, 0)))
  with telemetry.stage("kernel"):
    outs, _ = executor.run(x)
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
  with telemetry.stage("d2h"):
    return [to_host(o) for o in outs]


def batched_downsample(
  layer_path: str,
  mip: int = 0,
  num_mips: int = 4,
  shape: Sequence[int] = (256, 256, 64),
  batch_size: int = 8,
  factor: Sequence[int] = DEFAULT_FACTOR,
  sparse: bool = False,
  fill_missing: bool = False,
  compress="gzip",
  method: str = "auto",
  bounds: Optional[Bbox] = None,
  drain_flag=None,
) -> dict:
  """Downsample a whole layer with batched device launches.

  Creates the destination scales (as ``create_downsampling_tasks``
  does), then runs the grid in batches of ``batch_size`` full cutouts,
  then the ragged edge cutouts through ``PagedPyramid``. ``bounds`` (at
  ``mip``) restricts the region. ``drain_flag`` (anything with
  ``is_set()``): the batch in flight finishes its uploads, the remaining
  cells are skipped and ``stats["drained"]`` says so.

  Returns {"batched_cutouts", "edge_cutouts" (solo task path),
  "paged_cutouts", "dispatches", "drained"}."""
  from ..downsample_scales import create_downsample_scales
  from ..pipeline import shared_encode_pool, shared_prefetch_pool
  from ..tasks.image import downsample_and_upload
  from .paged import PagedPyramid, pages_compatible

  vol = Volume(layer_path, mip=mip, fill_missing=fill_missing)
  # chunk-size guard: every produced mip must stay chunk-writable
  factors = compute_factors(
    shape, factor, num_mips, chunk_size=vol.meta.chunk_size(mip)
  )
  if not factors:
    raise ValueError(
      f"shape {list(shape)} admits no chunk-aligned downsamples by "
      f"{list(factor)} (chunk {vol.meta.chunk_size(mip).tolist()})"
    )
  create_downsample_scales(vol.meta, mip, shape, factor, num_mips=len(factors))
  vol.commit_info()

  method = pooling.method_for_layer(vol.layer_type, method)
  bounds = get_bounds(vol, bounds, mip, mip)
  shape = Vec(*shape)

  full_boxes, edge_offsets = [], []  # edge: nominal offsets; tasks clamp
  for gbox in chunk_bboxes(bounds, shape, offset=bounds.minpt, clamp=False):
    clipped = Bbox.intersection(gbox, bounds)
    if clipped == gbox:
      full_boxes.append(gbox)
    elif not clipped.empty():
      edge_offsets.append(gbox.minpt)

  executor = cached_chunk_executor(factors=tuple(factors), method=method, sparse=sparse)
  stats = {"batched_cutouts": 0, "edge_cutouts": 0, "paged_cutouts": 0,
           "dispatches": 0, "drained": False}

  def draining() -> bool:
    if drain_flag is not None and drain_flag.is_set():
      stats["drained"] = True
    return stats["drained"]

  def download(box):
    with telemetry.stage("download"):
      return vol.download(box)

  def upload_batch(boxes, mips_out):
    """Every chunk's encode and put through the shared encode pool under
    one ticket, which the caller joins one batch later."""
    ticket = shared_encode_pool().ticket()
    for mip_idx, batch_arr in enumerate(mips_out):
      f = Vec(*np.prod(np.asarray(factors[: mip_idx + 1]), axis=0))
      dest_mip = mip + mip_idx + 1
      for k, box in enumerate(boxes):
        mn = box.minpt // f
        arr = batch_arr[k].transpose(3, 2, 1, 0)  # (x, y, z, c)
        dest_box = Bbox.intersection(
          Bbox(mn, mn + Vec(*arr.shape[:3])), vol.meta.bounds(dest_mip)
        )
        sl = tuple(slice(0, int(s)) for s in dest_box.size3())
        vol.upload(
          dest_box, arr[sl].astype(vol.dtype, copy=False), dest_mip, compress,
          sink=ticket,
        )
    return ticket

  # double buffering: batch i+1 downloads while batch i computes and
  # uploads (the prefetch pool's threads hand each cutout's chunk reads to
  # Volume.download's own threads, so they never wait on themselves)
  batches = [full_boxes[i : i + batch_size] for i in range(0, len(full_boxes), batch_size)]
  io_pool = shared_prefetch_pool()
  pending = [io_pool.submit(download, b) for b in batches[0]] if batches else []
  prev_ticket = None
  for i, batch in enumerate(batches):
    if draining():
      break
    with telemetry.stage("download_wait"):
      imgs = [f.result() for f in pending]
    pending = (
      [io_pool.submit(download, b) for b in batches[i + 1]]
      if i + 1 < len(batches) else []
    )
    mips_out = device_pyramid_batch(executor, imgs)
    del imgs
    stats["batched_cutouts"] += len(batch)
    stats["dispatches"] += 1
    # join batch i-1's uploads only now: they overlapped batch i's
    # downloads and this batch's launches
    if prev_ticket is not None:
      with telemetry.stage("upload_wait"):
        prev_ticket.join()
    prev_ticket = upload_batch(batch, mips_out)
  if prev_ticket is not None:
    with telemetry.stage("upload_wait"):
      prev_ticket.join()
  for f in pending:  # drained mid-stream: settle the abandoned downloads
    try:
      f.result()
    except Exception:  # noqa: BLE001 - nothing consumes them
      pass

  if edge_offsets and pages_compatible(tuple(factors)) and not draining():
    # ragged edge cells: the paged pyramid packs every clamped cutout into
    # fixed pages, so edges ride the same launches as every other round
    edge_boxes = [
      Bbox.intersection(Bbox(offset, offset + shape), bounds)
      for offset in edge_offsets
    ]
    futs = [io_pool.submit(download, b) for b in edge_boxes]
    with telemetry.stage("download_wait"):
      imgs = [f.result() for f in futs]
    pyramid = PagedPyramid(imgs, tuple(factors), len(factors), method=method, sparse=sparse)
    del imgs
    ticket = shared_encode_pool().ticket()
    while pyramid.pending and not draining():
      for idx in pyramid.run_round():
        # the solo task's own upload routine, fed the paged mips
        downsample_and_upload(
          None, edge_boxes[idx], vol, task_shape=shape.tolist(), mip=mip,
          num_mips=len(factors), factor=tuple(factor), sparse=sparse,
          method=method, compress=compress,
          _mips_out=pyramid.result(idx), sink=ticket,
        )
        stats["paged_cutouts"] += 1
      stats["dispatches"] += 1
    with telemetry.stage("upload_wait"):
      ticket.join()
  else:
    for offset in edge_offsets:
      if draining():
        break
      DownsampleTask(
        layer_path=layer_path, mip=mip, shape=shape.tolist(),
        offset=[int(v) for v in offset], fill_missing=fill_missing,
        sparse=sparse, num_mips=len(factors), factor=tuple(factor),
        compress=compress, downsample_method=method,
      ).execute()
      stats["edge_cutouts"] += 1
  return stats


# ---------------------------------------------------------------------------
# batched CCL pass 1 and skeleton forge


def _chunked(items, size):
  return [items[i : i + size] for i in range(0, len(items), size)]


def _prefetched(groups, prep):
  """Yield each group's prepared items, preparing group i+1 on threads
  while the caller works on group i."""
  with cf.ThreadPoolExecutor(max_workers=8) as io_pool:
    pending = [io_pool.submit(prep, t) for t in groups[0]] if groups else []
    for i in range(len(groups)):
      with telemetry.stage("download_wait"):
        preps = [f.result() for f in pending]
      pending = (
        [io_pool.submit(prep, t) for t in groups[i + 1]]
        if i + 1 < len(groups) else []
      )
      yield preps


def batched_ccl_faces(
  src_path: str,
  mip: int = 0,
  shape: Sequence[int] = (448, 448, 448),
  batch_size: int = 8,
  threshold_gte=None,
  threshold_lte=None,
  fill_missing: bool = False,
) -> dict:
  """CCL pass 1 over a whole layer with batched device launches.

  Runs the task grid ``create_ccl_face_tasks`` builds (the same
  task_nums, offsets and face files: later passes cannot tell the
  difference). Cutouts go through ``paged_ccl`` in prefetched groups of
  ``batch_size``, whatever their shapes. Where the CCL tile cannot page
  (``ccl_page_compatible``), cutouts of one shape go through
  ``connected_components_batch`` together, and a shape with one member
  takes the task path."""
  from ..ops.ccl import _batch_executor, connected_components_batch
  from ..storage import CloudFiles
  from ..task_creation.ccl import create_ccl_face_tasks
  from ..tasks.ccl import (
    _offset_components, _prep_ccl_image, ccl_scratch_path, store_ccl_faces,
  )
  from .paged import ccl_page_compatible, paged_ccl

  tasks = list(create_ccl_face_tasks(
    src_path, mip=mip, shape=shape, threshold_gte=threshold_gte,
    threshold_lte=threshold_lte, fill_missing=fill_missing,
  ))
  stats = {"batched_cutouts": 0, "edge_cutouts": 0, "dispatches": 0}
  files = CloudFiles(src_path)
  scratch = ccl_scratch_path(src_path, mip)

  def prep(task):
    img, cutout, core = _prep_ccl_image(
      src_path, mip, task.shape, task.offset, fill_missing,
      threshold_gte, threshold_lte, task.dust_threshold,
    )
    return task, img, cutout, core

  def store(preps, comps):
    for (task, _img, cutout, core), cc in zip(preps, comps):
      with telemetry.stage("offset"):
        cc = _offset_components(cc, task.task_num, task.shape)
      with telemetry.stage("faces"):
        store_ccl_faces(cc, cutout, core, task.task_num, files, scratch)
      stats["batched_cutouts"] += 1

  if ccl_page_compatible():
    for preps in _prefetched(_chunked(tasks, batch_size), prep):
      store(preps, paged_ccl([p[1] for p in preps], 6))
      stats["dispatches"] += 1
    return stats

  executor = _batch_executor(6)
  vol = Volume(src_path, mip=mip)
  bounds = vol.meta.bounds(mip)
  by_shape = {}
  for t in tasks:
    cutout = Bbox.intersection(Bbox(t.offset, t.offset + t.shape + 1), bounds)
    by_shape.setdefault(tuple(cutout.size3()), []).append(t)
  for members in by_shape.values():
    if len(members) == 1:
      members[0].execute()
      stats["edge_cutouts"] += 1
      continue
    for preps in _prefetched(_chunked(members, batch_size), prep):
      imgs = np.stack([p[1] for p in preps])
      store(preps, connected_components_batch(imgs, executor=executor))
      stats["dispatches"] += 1
  return stats


def batched_skeleton_forge(
  cloudpath: str,
  mip: int = 0,
  shape: Sequence[int] = (512, 512, 512),
  batch_size: int = 4,
  **skeleton_kwargs,
) -> dict:
  """Skeleton forge with the EDT batched across tasks.

  Tasks stream in prefetched groups of ``batch_size``, whatever their
  cutouts' shapes, through ``paged_edt`` (three launches a group); each
  task then traces and uploads through ``SkeletonTask.execute(_prepared,
  _edt_field)``. The fragments are those of solo task execution."""
  from ..task_creation.skeleton import create_skeletonizing_tasks
  from .paged import paged_edt

  tasks = list(create_skeletonizing_tasks(
    cloudpath, mip=mip, shape=shape, **skeleton_kwargs
  ))
  vol = Volume(cloudpath, mip=mip)
  anis = tuple(float(v) for v in vol.resolution)
  bounds = vol.meta.bounds(mip)
  stats = {"batched_cutouts": 0, "solo_cutouts": 0, "dispatches": 0}
  eligible = [
    t for t in tasks
    if not Bbox.intersection(Bbox(t.offset, t.offset + t.shape), bounds).empty()
  ]

  def prep(task):
    return task, task.prepare_labels(
      Volume(cloudpath, mip=mip, fill_missing=task.fill_missing)
    )

  for preps in _prefetched(_chunked(eligible, batch_size), prep):
    preps = [(t, p) for t, p in preps if p is not None]
    if not preps:
      continue
    fields = paged_edt([p[0] for _, p in preps], anis)
    stats["dispatches"] += 1
    for (task, prepared), field in zip(preps, fields):
      task.execute(_prepared=prepared, _edt_field=field)
      stats["batched_cutouts"] += 1
  return stats
