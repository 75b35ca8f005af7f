"""Convert an HDF5 remap table to .npy for ``WatershedRemapTask``.

The port's own copy of ``igneous_tpu/scripts/remap2npy.py``: watershed
remap tables were distributed as HDF5, and ``WatershedRemapTask`` reads
.npy. It reads the ``main`` dataset (else the first dataset) through
``formats.load_hdf5`` and writes ``<input>.npy`` beside the source.

Usage:
  python -m igneous_tpu_torch.scripts.remap2npy TABLE.h5 [TABLE2.h5 ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def convert(path: str) -> str:
  from ..formats import load_hdf5

  arr = np.asarray(load_hdf5(path))
  out = os.path.splitext(path)[0] + ".npy"
  np.save(out, arr)
  return out


def main(argv=None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  if not argv:
    print(__doc__.strip(), file=sys.stderr)
    return 2
  for path in argv:
    out = convert(path)
    print(f"{path} -> {out}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
