"""The integrity audit task: a grid cell's stored chunks against the envelope.

The port's own copy of ``igneous_tpu/tasks/audit.py``. An
``IntegrityAuditTask`` covers one grid cell of one mip: it lists the
chunks the cell must hold (the download path's own enumeration) and
classifies each:

  missing          the object is absent
  decode_error     its stored bytes fail to decompress (a torn gzip, ...)
  digest_mismatch  they decompress but differ from the manifest's digest

Findings land as one JSONL file per (mip, cell) under the report
directory, with a summary line first; a chunk that is present and sound
but has no manifest record counts as ``unmanifested``, not as a finding.
"""

from __future__ import annotations

import json

from .. import integrity, telemetry
from ..lib import Bbox, Vec, chunk_bboxes
from ..queues.registry import RegisteredTask
from ..storage import COMPRESSION_EXTS, CloudFiles, decompress_bytes
from ..volume import Volume


def expected_chunks(vol: Volume, bounds: Bbox, mip: int):
  """Grid-aligned, bounds-clamped chunk boxes inside ``bounds``."""
  full = vol.meta.bounds(mip)
  inner = Bbox.intersection(bounds, full)
  chunks = (
    Bbox.intersection(gc, full)
    for gc in chunk_bboxes(
      inner, vol.meta.chunk_size(mip), offset=vol.meta.voxel_offset(mip), clamp=False,
    )
  )
  return [c for c in chunks if not c.empty()]


def report_name(mip: int, offset) -> str:
  x, y, z = (int(v) for v in offset)
  return f"findings_{mip}_{x}_{y}_{z}.jsonl"


class IntegrityAuditTask(RegisteredTask):
  """Check presence, decode and manifest digest of every chunk of one
  grid cell at one mip, and write its findings report."""

  def __init__(
    self,
    layer_path: str,
    mip: int,
    shape,
    offset,
    report_dir: str,
    check_digest: bool = True,
    require_present: bool = True,
  ):
    self.layer_path = layer_path
    self.mip = mip
    self.shape = shape
    self.offset = offset
    self.report_dir = report_dir
    self.check_digest = check_digest
    self.require_present = require_present

  def trace_attrs(self) -> dict:
    """Task-span attributes for ``fleet top|trace``."""
    return {"mip": int(self.mip), "layer": self.layer_path[-60:]}

  def execute(self):
    vol = Volume(self.layer_path, mip=self.mip, bounded=False)
    bounds = Bbox(Vec(*self.offset), Vec(*self.offset) + Vec(*self.shape))
    chunks = expected_chunks(vol, bounds, self.mip)
    cf = CloudFiles(self.layer_path)
    manifest = (
      integrity.load_manifest(self.layer_path, prefix=vol.meta.key(self.mip))
      if self.check_digest else {}
    )

    findings = []
    unmanifested = 0
    for chunk_bbx in chunks:
      key = vol.meta.chunk_name(self.mip, chunk_bbx)
      stored, method = cf.get_stored(key)
      if stored is None:
        if self.require_present:
          findings.append(self._finding("missing", key, chunk_bbx))
        continue
      try:
        decompress_bytes(stored, method)
      except Exception as e:
        findings.append(self._finding(
          "decode_error", key, chunk_bbx, reason=f"{type(e).__name__}: {e}",
        ))
        continue
      if not self.check_digest:
        continue
      rec = manifest.get(key + COMPRESSION_EXTS[method])
      if rec is None:
        unmanifested += 1
        continue
      actual = integrity.digest_hex(stored)
      if actual != rec["digest"]:
        findings.append(self._finding(
          "digest_mismatch", key, chunk_bbx, expected=rec["digest"], actual=actual,
        ))

    telemetry.incr("integrity.audit.chunks", len(chunks))
    if findings:
      telemetry.incr("integrity.audit.findings", len(findings))
    summary = {
      "kind": "summary",
      "mip": int(self.mip),
      "chunks": len(chunks),
      "findings": len(findings),
      "unmanifested": unmanifested,
    }
    body = "".join(json.dumps(rec, sort_keys=True) + "\n" for rec in [summary] + findings)
    CloudFiles(self.report_dir).put(
      report_name(self.mip, self.offset), body.encode("utf8"), compress=None
    )
    return summary

  def _finding(self, kind: str, key: str, chunk_bbx: Bbox, **extra) -> dict:
    out = {"kind": kind, "key": key, "mip": int(self.mip), "bbox": chunk_bbx.to_list()}
    out.update(extra)
    return out
