"""Graphene id maps on the port's device.

A graphene volume's supervoxel cutout becomes proofread root ids or L2
chunk-graph ids through a client (``graphene.py``'s local chunk graph, or
``graphene_http.PCGClient``). The JAX package hands the client the whole
cutout; here the per-voxel work stays on the device and the client sees
only distinct values:

- ``map_on_device``: the cutout's unique ids and their inverse on the
  device, the lookup on the host for the unique ids, the answers gathered
  back on the device;
- ``l2_ids_on_device``: the voxel chunk index (``graphene.voxel_chunk_index``)
  computed on the device, the unique (supervoxel, chunk) pairs found there,
  in numpy's unsigned lexicographic order (ids at or above 2^63 last), the
  client's ``get_l2_ids`` called on the pairs, its answers gathered back.

Every client maps value by value (the local graph numbers L2 ids on first
sight of each (root, chunk) pair in ``np.unique`` order, and the pairs of
the unique (supervoxel, chunk) pairs are the cutout's pairs), so the ids
equal the JAX package's. Results come back as (x, y, z) uint64 numpy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import get_device
from ..observability.device import execute_span, transfer_span
from .mesh import labels_on_device

_SIGN = -(1 << 63)


def _unique_ids(sv: np.ndarray, dev):
  """(the unique ids as uint64 numpy in numpy's order, their (z, y, x)
  int64 inverse on ``dev``)."""
  seg, flip = labels_on_device(sv, (0, 0, 0), (0, 0, 0), dev)
  shape = tuple(seg.shape)
  with execute_span("graphene.unique", seg.numel(), seg.numel() * 16, dev,
                    signature=(shape,)):
    key = torch.bitwise_xor(seg, _SIGN) if flip else seg
    del seg
    uniq, inv = torch.unique(key.reshape(-1), sorted=True, return_inverse=True)
    del key
    if flip:
      uniq = torch.bitwise_xor(uniq, _SIGN)
  with transfer_span("d2h", uniq.numel() * 8, dev):
    ids = uniq.cpu().numpy().view(np.uint64)
  return ids, inv.view(shape)


def _take(values: np.ndarray, inv: torch.Tensor) -> torch.Tensor:
  """uint64 ``values`` (one per unique id or pair) gathered by the device
  index ``inv``: an int64 tensor holding the uint64 bits."""
  dev = inv.device
  vals = np.ascontiguousarray(np.asarray(values, dtype=np.uint64)).view(np.int64)
  with transfer_span("h2d", vals.nbytes, dev):
    table = torch.from_numpy(vals).to(dev)
  with execute_span("graphene.gather", inv.numel(), inv.numel() * 16, dev,
                    signature=(tuple(inv.shape),)):
    return table[inv]


def _to_numpy(ids: torch.Tensor) -> np.ndarray:
  """A (z, y, x) int64 tensor of uint64 bits -> (x, y, z) uint64 numpy."""
  with transfer_span("d2h", ids.numel() * 8, ids.device):
    return ids.cpu().numpy().view(np.uint64).transpose(2, 1, 0)


def map_on_device(
  sv: np.ndarray, lookup: Callable[[np.ndarray], np.ndarray], dev,
) -> torch.Tensor:
  """The (z, y, x) int64 tensor on ``dev`` of ``lookup`` applied to every
  voxel of the (x, y, z) cutout ``sv``: ``lookup`` receives the unique ids
  (uint64 numpy) and returns one uint64 per id."""
  ids, inv = _unique_ids(sv, dev)
  return _take(lookup(ids), inv)


def roots_on_device(client, sv: np.ndarray, timestamp=None, dev=None) -> np.ndarray:
  """Per-voxel proofread root ids of the supervoxel cutout ``sv`` as of
  ``timestamp``: (x, y, z) uint64."""
  dev = get_device() if dev is None else dev
  return _to_numpy(map_on_device(sv, lambda ids: client.get_roots(ids, timestamp), dev))


def chunk_axes(minpt, shape, chunk_size, scale=(1, 1, 1)):
  """Per axis (x, y, z), the graph-chunk coordinate of every voxel of a
  cutout at ``minpt`` of ``shape``: int64 numpy arrays, as
  ``graphene.voxel_chunk_index`` computes them."""
  return [
    ((int(m) + np.arange(int(n), dtype=np.int64)) * int(s)) // int(c)
    for m, n, s, c in zip(minpt, shape, scale, chunk_size)
  ]


def l2_ids_on_device(
  client, sv: np.ndarray, minpt: Sequence[int], chunk_size: Sequence[int],
  scale: Sequence[int] = (1, 1, 1), timestamp: Optional[float] = None, dev=None,
) -> np.ndarray:
  """Per-voxel L2 ids of the supervoxel cutout ``sv`` at global ``minpt``
  (its mip's voxels; ``scale`` the mip -> base ratio the chunk grid is
  defined at): (x, y, z) uint64. The client's ``get_l2_ids`` receives the
  cutout's unique (supervoxel, linear chunk index) pairs."""
  dev = get_device() if dev is None else dev
  ids, inv = _unique_ids(sv, dev)
  shape = tuple(inv.shape)
  gx, gy, gz = chunk_axes(minpt, sv.shape[:3], chunk_size, scale)
  nx, ny, nz = (int(g[-1] - g[0]) + 1 for g in (gx, gy, gz))
  nchunks = nx * ny * nz
  with execute_span("graphene.pairs", inv.numel(), inv.numel() * 24, dev,
                    signature=(shape,)):
    lx = torch.from_numpy(gx - gx[0]).to(dev).view(1, 1, -1)
    ly = torch.from_numpy(gy - gy[0]).to(dev).view(1, -1, 1)
    lz = torch.from_numpy(gz - gz[0]).to(dev).view(-1, 1, 1)
    # (supervoxel rank, local chunk) codes: their order is numpy's order
    # of the (supervoxel, chunk) pairs, since the local chunk index rises
    # with z, then y, then x, as the linear index does
    code = inv * nchunks + ((lz * ny + ly) * nx + lx)
    pairs, pair_inv = torch.unique(code.reshape(-1), sorted=True, return_inverse=True)
    del code
  with transfer_span("d2h", pairs.numel() * 8, dev):
    pairs = pairs.cpu().numpy()
  local = pairs % nchunks
  cx = gx[0] + local % nx
  cy = gy[0] + (local // nx) % ny
  cz = gz[0] + local // (nx * ny)
  chunks = (cx + (cy << np.int64(20)) + (cz << np.int64(40))).astype(np.uint64)
  l2 = client.get_l2_ids(ids[pairs // nchunks], chunks, timestamp)
  return _to_numpy(_take(l2, pair_inv.view(shape)))
