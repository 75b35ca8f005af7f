"""Audit the provenance files of every layer under a root path.

The port's own copy of ``igneous_tpu/scripts/validate_provenance.py``: it
walks the layers under a root on the port's ``CloudFiles`` and reports
those whose provenance document is missing or malformed.

Usage: python -m igneous_tpu_torch.scripts.validate_provenance file:///data/bucket
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

from ..storage import CloudFiles

REQUIRED_KEYS = ("description", "owners", "processing", "sources")


def validate_provenance(root: str) -> Dict[str, List[str]]:
  """{layer path: [problems]}; an empty dict when every layer is valid.

  A layer is a directory whose info JSON has "scales" (a Precomputed
  image or segmentation). The infos of mesh and skeleton directories are
  skipped: they carry no provenance."""
  cf = CloudFiles(root)
  candidates = sorted({
    key.rsplit("/", 1)[0] if "/" in key else "info"
    for key in cf.list()
    if key.endswith("/info") or key == "info"
  })
  problems: Dict[str, List[str]] = {}
  for layer in candidates:
    prefix = "" if layer == "info" else layer + "/"
    info = cf.get_json(f"{prefix}info")
    if not isinstance(info, dict) or "scales" not in info:
      continue  # a mesh or skeleton directory's info
    errs = []
    raw = cf.get(f"{prefix}provenance")
    if raw is None:
      errs.append("missing provenance file")
    else:
      try:
        doc = json.loads(raw.decode("utf8"))
        for k in REQUIRED_KEYS:
          if k not in doc:
            errs.append(f"missing key {k!r}")
        for i, entry in enumerate(doc.get("processing", [])):
          if "method" not in entry:
            errs.append(f"processing[{i}] lacks 'method'")
      except (ValueError, UnicodeDecodeError):
        errs.append("provenance is not valid JSON")
    if errs:
      problems[layer.rstrip("/") or root] = errs
  return problems


def main():
  if len(sys.argv) != 2:
    print(__doc__)
    sys.exit(2)
  problems = validate_provenance(sys.argv[1])
  if not problems:
    print("all provenance files valid")
    return
  for layer, errs in problems.items():
    for e in errs:
      print(f"{layer}: {e}")
  sys.exit(1)


if __name__ == "__main__":
  main()
