"""DBSCAN clustering on the host.

The port's own copy of ``igneous_tpu/ops/dbscan.py`` (the ``dbscan``
package's semantics on a cKDTree eps-graph): core points have at least
``min_samples`` neighbors within ``eps`` (self included); clusters are
connected components of core points, with border points attached to an
adjacent core's cluster; everything else is noise (-1). The skeleton
cross-section repair clusters its clipped vertices with it, one context
download a cluster.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def dbscan(
  points: np.ndarray, eps: float, min_samples: int = 1
) -> np.ndarray:
  """points: (n, d) → int labels (n,), clusters 0..k-1, noise -1."""
  points = np.asarray(points, dtype=np.float64)
  n = len(points)
  if n == 0:
    return np.zeros(0, dtype=np.int64)
  tree = cKDTree(points)
  pairs = tree.query_pairs(float(eps), output_type="ndarray")

  degree = np.ones(n, dtype=np.int64)  # self counts
  if len(pairs):
    np.add.at(degree, pairs[:, 0], 1)
    np.add.at(degree, pairs[:, 1], 1)
  core = degree >= int(min_samples)

  parent = np.arange(n, dtype=np.int64)

  def find(x):
    root = x
    while parent[root] != root:
      root = parent[root]
    while parent[x] != root:
      parent[x], x = root, parent[x]
    return root

  for a, b in pairs:
    if core[a] and core[b]:
      ra, rb = find(int(a)), find(int(b))
      if ra != rb:
        parent[max(ra, rb)] = min(ra, rb)

  labels = np.full(n, -1, dtype=np.int64)
  roots = {}
  for i in range(n):
    if core[i]:
      r = find(i)
      if r not in roots:
        roots[r] = len(roots)
      labels[i] = roots[r]
  # border points: attach to any adjacent core cluster
  for a, b in pairs:
    a, b = int(a), int(b)
    if core[a] and not core[b] and labels[b] == -1:
      labels[b] = labels[find(a)]
    elif core[b] and not core[a] and labels[a] == -1:
      labels[a] = labels[find(b)]
  return labels
