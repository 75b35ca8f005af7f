"""Label remapping on the host, in numpy.

The port's own copy of ``remap`` and ``inverse_component_map`` from
``igneous_tpu/ops/remap.py`` (the fastremap functions the CCL passes use).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def remap(
  arr: np.ndarray,
  table: Dict[int, int],
  preserve_missing_labels: bool = False,
) -> np.ndarray:
  """Apply {old: new} to arr. Missing labels raise unless preserved."""
  if len(table) == 0:
    if preserve_missing_labels:
      return arr.copy()
    if arr.size and arr.any():
      raise KeyError("empty remap table for nonempty array")
    return arr.copy()
  keys = np.fromiter(table.keys(), dtype=arr.dtype, count=len(table))
  vals = np.fromiter(table.values(), dtype=arr.dtype, count=len(table))
  order = np.argsort(keys)
  keys, vals = keys[order], vals[order]
  idx = np.searchsorted(keys, arr)
  idx_c = np.clip(idx, 0, len(keys) - 1)
  found = keys[idx_c] == arr
  if preserve_missing_labels:
    return np.where(found, vals[idx_c], arr)
  if not bool(found.all()):
    missing = np.unique(arr[~found])
    raise KeyError(f"labels not in remap table: {missing[:10].tolist()}…")
  return vals[idx_c]


def inverse_component_map(a: np.ndarray, b: np.ndarray) -> Dict[int, np.ndarray]:
  """For each nonzero label in ``a``: the set of nonzero ``b`` labels that
  co-occur at the same positions (the CCL face-linking primitive)."""
  a = a.reshape(-1)
  b = b.reshape(-1)
  sel = (a != 0) & (b != 0)
  if not sel.any():
    return {}
  pairs = np.stack([a[sel].astype(np.uint64), b[sel].astype(np.uint64)], axis=1)
  pairs = np.unique(pairs, axis=0)
  out: Dict[int, np.ndarray] = {}
  split_at = np.flatnonzero(np.diff(pairs[:, 0])) + 1
  for g in np.split(pairs, split_at):
    out[int(g[0, 0])] = g[:, 1]
  return out
