"""Audit and repair factories.

The port's own copy of ``igneous_tpu/task_creation/audit.py``.
``create_integrity_audit_tasks`` lays an ``IntegrityAuditTask`` grid over
one mip of a layer (cells of 8x8x4 chunks by default, bounds resolved as
the other factories resolve them). ``downsample_repair_tasks`` reads the
downsample campaign recorded in the layer's provenance, maps each damaged
chunk back to the task-grid cell of the source mip that wrote it, and
makes one ``DownsampleTask`` per damaged cell: it rewrites every mip of
the cell with the same bytes, since the pyramid and gzip (``mtime=0``)
are deterministic.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Sequence, Tuple

from ..lib import Bbox, Vec
from ..storage import CloudFiles
from ..tasks.audit import IntegrityAuditTask
from ..tasks.image import DownsampleTask
from ..volume import Volume
from .common import GridTaskIterator, get_bounds

DEFAULT_CELL_CHUNKS = (8, 8, 4)


def create_integrity_audit_tasks(
  layer_path: str,
  mip: int,
  report_dir: str,
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  shape: Optional[Sequence[int]] = None,
  check_digest: bool = True,
  require_present: bool = True,
):
  """Tasks auditing ``mip`` of ``layer_path``; findings land under
  ``report_dir``, one file per grid cell."""
  vol = Volume(layer_path, mip=mip)
  if shape is None:
    shape = vol.meta.chunk_size(mip) * Vec(*DEFAULT_CELL_CHUNKS)
  shape = Vec(*shape)
  task_bounds = get_bounds(vol, bounds, mip, bounds_mip)

  def make_task(shape_: Vec, offset: Vec):
    return IntegrityAuditTask(
      layer_path=layer_path,
      mip=mip,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      report_dir=report_dir,
      check_digest=check_digest,
      require_present=require_present,
    )

  return GridTaskIterator(task_bounds, shape, make_task)


def load_findings(report_dir: str) -> Tuple[List[dict], dict]:
  """(findings, totals) of every cell report under ``report_dir``, each
  finding once by (mip, key)."""
  cf = CloudFiles(report_dir)
  findings: List[dict] = []
  totals = {"chunks": 0, "findings": 0, "unmanifested": 0, "cells": 0}
  for name in sorted(cf.list("")):
    base = name.rsplit("/", 1)[-1]
    if not (base.startswith("findings_") and base.endswith(".jsonl")):
      continue
    raw = cf.get(name)
    if raw is None:
      continue
    for line in raw.splitlines():
      if not line.strip():
        continue
      rec = json.loads(line)
      if rec.get("kind") == "summary":
        totals["cells"] += 1
        for field in ("chunks", "findings", "unmanifested"):
          totals[field] += int(rec.get(field, 0))
      else:
        findings.append(rec)
  # at-least-once delivery can report a cell twice
  seen = set()
  unique = []
  for f in sorted(findings, key=lambda f: (f["mip"], f["key"], f["kind"])):
    k = (f["mip"], f["key"])
    if k not in seen:
      seen.add(k)
      unique.append(f)
  return unique, totals


def downsample_provenance(vol: Volume) -> Optional[dict]:
  """The latest DownsampleTask campaign in the layer's provenance."""
  prov = vol.meta.refresh_provenance()
  for entry in reversed(prov.get("processing", [])):
    method = entry.get("method", {})
    if isinstance(method, dict) and method.get("task") == "DownsampleTask":
      return method
  return None


def downsample_repair_tasks(
  layer_path: str,
  findings: Iterable[dict],
  provenance: Optional[dict] = None,
) -> Tuple[List[DownsampleTask], List[dict]]:
  """(repair tasks, unhealable findings). A finding at or below the
  campaign's source mip, or above its last mip, has no producer here."""
  vol = Volume(layer_path, mip=0, bounded=False)
  prov = provenance if provenance is not None else downsample_provenance(vol)
  if prov is None:
    return [], list(findings)

  src_mip = int(prov["mip"])
  shape = Vec(*prov["shape"])
  task_bounds = Bbox.from_list(prov["bounds"])
  cells = set()
  unhealable = []
  for f in findings:
    fmip = int(f["mip"])
    if fmip <= src_mip or fmip > src_mip + int(prov["num_mips"]):
      unhealable.append(f)
      continue
    at_src = vol.meta.bbox_to_mip(Bbox.from_list(f["bbox"]), fmip, src_mip)
    lo = (at_src.minpt - task_bounds.minpt) // shape
    hi = (at_src.maxpt - Vec(1, 1, 1) - task_bounds.minpt) // shape
    for x in range(int(lo.x), int(hi.x) + 1):
      for y in range(int(lo.y), int(hi.y) + 1):
        for z in range(int(lo.z), int(hi.z) + 1):
          cells.add((x, y, z))

  tasks = []
  for cell in sorted(cells):
    offset = task_bounds.minpt + Vec(*cell) * shape
    tasks.append(DownsampleTask(
      layer_path=layer_path,
      mip=src_mip,
      shape=shape.tolist(),
      offset=offset.tolist(),
      fill_missing=bool(prov.get("fill_missing", False)),
      sparse=bool(prov.get("sparse", False)),
      delete_black_uploads=bool(prov.get("delete_black_uploads", False)),
      background_color=int(prov.get("background_color", 0)),
      compress=prov.get("compress", "gzip"),
      downsample_method=prov.get("method", "auto"),
      num_mips=int(prov["num_mips"]),
      factor=tuple(prov["factor"]),
    ))
  return tasks, unhealable
