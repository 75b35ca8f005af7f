"""Label remapping on the host, in numpy.

The port's own copy of ``remap``, ``renumber``, ``unique``, ``mask``,
``mask_except`` and ``inverse_component_map`` from
``igneous_tpu/ops/remap.py`` (the fastremap functions the CCL passes and
the mesh forge use).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

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


def renumber(
  arr: np.ndarray, start: int = 1, preserve_zero: bool = True
) -> Tuple[np.ndarray, Dict[int, int]]:
  """Relabel to a dense range; returns (renumbered, {new: old})."""
  uniq = np.unique(arr)
  if preserve_zero:
    uniq = uniq[uniq != 0]
  n = len(uniq) + start
  if n < 2**16:
    dtype = np.uint16
  elif n < 2**32:
    dtype = np.uint32
  else:
    dtype = np.uint64
  out = (np.searchsorted(uniq, arr) + start).astype(dtype)
  if preserve_zero:
    out[arr == 0] = 0
  mapping = {start + i: int(v) for i, v in enumerate(uniq.tolist())}
  if preserve_zero:
    mapping[0] = 0
  return out, mapping


def unique(arr: np.ndarray, return_counts: bool = False):
  return np.unique(arr, return_counts=return_counts)


def mask(arr: np.ndarray, labels: Iterable[int]) -> np.ndarray:
  """Zero out the given labels."""
  labels = np.asarray(sorted(set(int(l) for l in labels)), dtype=arr.dtype)
  if len(labels) == 0:
    return arr.copy()
  idx = np.clip(np.searchsorted(labels, arr), 0, len(labels) - 1)
  hit = labels[idx] == arr
  return np.where(hit, arr.dtype.type(0), arr)


def mask_except(arr: np.ndarray, labels: Iterable[int]) -> np.ndarray:
  """Zero out everything EXCEPT the given labels."""
  labels = np.asarray(sorted(set(int(l) for l in labels)), dtype=arr.dtype)
  if len(labels) == 0:
    return np.zeros_like(arr)
  idx = np.clip(np.searchsorted(labels, arr), 0, len(labels) - 1)
  hit = labels[idx] == arr
  return np.where(hit, arr, arr.dtype.type(0))


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
