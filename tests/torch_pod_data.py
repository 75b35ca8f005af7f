"""Seeded data of the two-rank pod in ``tests/test_torch_multihost.py``.

Imports only numpy, so the rank processes load the port and nothing of
the JAX package: a lease of 7 uint8 chunks, 3 uint64 label chunks (ids
above 2^32) and the JAX rig's 7 pages of three ragged items (two of them
partial), each from a fixed seed.
"""

import numpy as np

N_CHUNKS = 7
N_LABELS = 3
FACTORS = ((2, 2, 1), (2, 2, 1))


def _chunks():
  rng = np.random.default_rng(0)
  return rng.integers(0, 255, (N_CHUNKS, 1, 8, 16, 16)).astype(np.uint8)


def _labels():
  rng = np.random.default_rng(2)
  base = rng.integers(0, 4, (N_LABELS, 1, 4, 8, 8)).astype(np.uint64)
  return base * np.uint64(2**33 + 7) + np.uint64(2**40)


def _pages():
  """The JAX rig's 7 pages of three ragged items, extents varied."""
  rng = np.random.default_rng(0)
  shapes = [(8, 8, 8), (16, 8, 8), (16, 16, 8)]
  items = [rng.integers(0, 255, s).astype(np.uint8) for s in shapes]
  pages = []
  for it in items:
    Z, Y, X = it.shape
    for oz in range(0, Z, 8):
      for oy in range(0, Y, 8):
        for ox in range(0, X, 8):
          pages.append(it[None, oz:oz + 8, oy:oy + 8, ox:ox + 8])
  pages = np.stack(pages)
  exts = np.full((len(pages), 3), 8, np.int32)
  exts[2] = (5, 8, 3)  # partial pages: the clamp-gathers replicate edges
  exts[6] = (8, 7, 6)
  return pages, exts
