"""Block connected-components labelling on the port's device.

Counterpart of ``igneous_tpu/ops/ccl.py`` (its tiled device path), with the
same numbering contract: components are renumbered 1..N in order of each
component's first voxel in Fortran (x-fastest) scan order, 0 stays
background, and two voxels connect iff their labels are equal and nonzero
and they are neighbours under 6/18/26-connectivity (cc3d semantics).

The path, per cutout:
  1. ``_dense_relabel`` (host, numpy): any integer labels -> int32 dense ids,
     so the card sees only int32;
  2. ``_ccl_tiled`` (device): cut the (z, y, x) volume into tiles, resolve
     each tile with ``cuda_ccl.tile_resolve``, turn each local root into the
     global flat index of that voxel over the tile-padded volume, mask the
     background to int32 max, untile;
  3. ``_merge_tile_roots`` (host, scipy): unite roots across tile faces;
  4. ``_roots_to_components`` (host, numpy): renumber 1..N.
The final labels do not depend on the tile shape: the renumbering depends
only on the partition.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from . import cuda_ccl
from .cuda_ccl import neighbor_offsets  # noqa: F401  (the port's ops.ccl API)

_BIG = np.iinfo(np.int32).max
_DEFAULT_TILE_CPU = (2, 4, 8)
# (tz, ty, tx) of the CUDA kernel: 64 KB of shared memory a tile (labels and
# parents), three blocks on an SM; a row of 32 is one warp's run of x. Of
# the tiles timed on an H100 (chip_smoke.py, tile sweep) it has the fewest
# tile faces for the host merge among those within a fifth of the fastest
# kernel on the mask case.
_DEFAULT_TILE_CUDA = (16, 16, 32)


def _tile_shape(device: Optional[torch.device] = None) -> Tuple[int, int, int]:
  """(tz, ty, tx) of the block-local resolve; ``IGNEOUS_CCL_TILE=tz,ty,tx``
  overrides the device's default."""
  spec = os.environ.get("IGNEOUS_CCL_TILE", "").strip()
  if not spec:
    device = get_device() if device is None else device
    return _DEFAULT_TILE_CUDA if device.type == "cuda" else _DEFAULT_TILE_CPU
  try:
    t = tuple(int(v) for v in spec.split(","))
  except ValueError:
    t = ()
  if len(t) != 3 or any(v < 1 for v in t):
    raise ValueError(
      f"IGNEOUS_CCL_TILE must be 'tz,ty,tx' positive ints: {spec!r}"
    )
  return t


def to_tiles(labels: torch.Tensor, tile: Tuple[int, int, int]):
  """(z, y, x) labels, or a (B, z, y, x) batch of them -> ((T, tz, ty, tx)
  contiguous tiles, (tz, ty, tx), (nz, ny, nx)), the tiles of a batch item
  after another's. Tiles are clipped to the volume, and the volume is
  padded with background to whole tiles, as ``_ccl_tiled_kernel`` does."""
  batch = labels if labels.dim() == 4 else labels[None]
  B, Z, Y, X = batch.shape
  tz, ty, tx = (min(t, s) for t, s in zip(tile, (Z, Y, X)))
  pz, py, px = (-Z) % tz, (-Y) % ty, (-X) % tx
  if (Z + pz) * (Y + py) * (X + px) > _BIG:
    raise ValueError(
      f"the tile-padded volume ({Z + pz}, {Y + py}, {X + px}) has more voxels "
      "than int32 flat indices can address; label smaller cutouts"
    )
  nz, ny, nx = (Z + pz) // tz, (Y + py) // ty, (X + px) // tx
  lab = torch.nn.functional.pad(batch, (0, px, 0, py, 0, pz))
  labt = (
    lab.view(B, nz, tz, ny, ty, nx, tx)
    .permute(0, 1, 3, 5, 2, 4, 6)
    .reshape(B * nz * ny * nx, tz, ty, tx)
    .contiguous()
  )
  return labt, (tz, ty, tx), (nz, ny, nx)


def _ccl_tiled_roots(
  labels: torch.Tensor, connectivity: int, tile: Tuple[int, int, int]
) -> torch.Tensor:
  """labels (z, y, x) int32 on the device -> per-voxel tile-local root as a
  global flat index over the tile-padded volume (background: int32 max),
  the output of ``_ccl_tiled_kernel``. A (B, z, y, x) batch gives (B, z,
  y, x) roots, each item's over its own volume, from one launch."""
  if labels.dim() == 3:
    return _ccl_tiled_roots(labels[None], connectivity, tile)[0]
  B, Z, Y, X = labels.shape
  labt, (tz, ty, tx), (nz, ny, nx) = to_tiles(labels, tile)
  Yp, Xp = ny * ty, nx * tx
  L = cuda_ccl.tile_resolve(labt, connectivity).view(B, nz, ny, nx, tz, ty, tx)
  # local root -> global flat index of that root voxel (in padded space)
  dev = labels.device
  lz = torch.div(L, ty * tx, rounding_mode="floor")
  rem = L - lz * (ty * tx)
  ly = torch.div(rem, tx, rounding_mode="floor")
  lx = rem - ly * tx
  iz = torch.arange(nz, dtype=torch.int32, device=dev).view(1, nz, 1, 1, 1, 1, 1)
  iy = torch.arange(ny, dtype=torch.int32, device=dev).view(1, 1, ny, 1, 1, 1, 1)
  ix = torch.arange(nx, dtype=torch.int32, device=dev).view(1, 1, 1, nx, 1, 1, 1)
  g = ((iz * tz + lz) * Yp + (iy * ty + ly)) * Xp + (ix * tx + lx)
  g = torch.where(labt.view(L.shape) != 0, g, _BIG)
  return (
    g.permute(0, 1, 4, 2, 5, 3, 6)
    .reshape(B, nz * tz, Yp, Xp)[:, :Z, :Y, :X]
    .contiguous()
  )


def _ccl_tiled(
  labels_zyx: np.ndarray, connectivity: int, dev: Optional[torch.device] = None
) -> np.ndarray:
  """Device tiled resolve + host boundary merge -> merged roots (z, y, x),
  on ``dev`` (default: the port's device)."""
  dev = get_device() if dev is None else dev
  tile = _tile_shape(dev)
  with telemetry.stage("h2d"):
    lab = torch.from_numpy(labels_zyx).to(dev)
  with telemetry.stage("kernel"):
    roots = _ccl_tiled_roots(lab, connectivity, tile)
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
  with telemetry.stage("d2h"):
    roots = roots.cpu().numpy()
  del lab
  with telemetry.stage("tile_merge"):
    return _merge_tile_roots(roots, labels_zyx, connectivity, tile)


def _merge_tile_roots(
  roots: np.ndarray, labels: np.ndarray, connectivity: int,
  tile: Tuple[int, int, int],
) -> np.ndarray:
  """Exact cross-tile merge (host side) of ``_ccl_tiled_roots`` output.

  roots, labels: (z, y, x) — tile-local roots (int32 global flat indices,
  int32-max sentinel = background) and the dense input labels. Every
  neighbour offset of the connectivity contributes (root_a, root_b) edges
  for equal-nonzero-label voxel pairs that straddle a tile boundary;
  connected components over those edges (scipy csgraph) pick each merged
  group's minimum root as its representative."""
  Z, Y, X = labels.shape
  tzyx = tuple(min(t, s) for t, s in zip(tile, labels.shape))
  coords = [np.arange(s) // t for s, t in zip((Z, Y, X), tzyx)]
  pa, pb = [], []
  for off in neighbor_offsets(connectivity):
    if off < (0, 0, 0):  # each unordered pair once (lexicographic half)
      continue
    src = tuple(
      slice(max(0, -d), s - max(0, d)) for d, s in zip(off, (Z, Y, X))
    )
    dst = tuple(
      slice(max(0, d), s - max(0, -d)) for d, s in zip(off, (Z, Y, X))
    )
    cross = None
    for a, d in enumerate(off):
      if d == 0:
        continue
      line = coords[a][src[a]] != coords[a][dst[a]]
      shape1 = [1, 1, 1]
      shape1[a] = line.size
      line = line.reshape(shape1)
      cross = line if cross is None else (cross | line)
    m = cross & (labels[src] != 0) & (labels[src] == labels[dst])
    if m.any():
      pa.append(roots[src][m])
      pb.append(roots[dst][m])
  if not pa:
    return roots
  ra = np.concatenate(pa)
  rb = np.concatenate(pb)
  nodes = np.unique(np.concatenate([ra, rb]))
  from scipy import sparse
  from scipy.sparse import csgraph

  g = sparse.coo_matrix(
    (
      np.ones(len(ra), dtype=np.int8),
      (np.searchsorted(nodes, ra), np.searchsorted(nodes, rb)),
    ),
    shape=(len(nodes), len(nodes)),
  )
  _, grp = csgraph.connected_components(g, directed=False)
  rep = np.full(int(grp.max()) + 1, np.iinfo(np.int64).max, dtype=np.int64)
  np.minimum.at(rep, grp, nodes.astype(np.int64))
  mapped = rep[grp].astype(roots.dtype)
  # remap: only roots that appear in a boundary edge can change
  flat = roots.reshape(-1)
  pos = np.searchsorted(nodes, flat)
  pos_c = np.minimum(pos, len(nodes) - 1)
  hit = nodes[pos_c] == flat
  out = flat.copy()
  out[hit] = mapped[pos_c[hit]]
  return out.reshape(roots.shape)


def connected_components(
  labels: np.ndarray, connectivity: int = 6, return_N: bool = False,
  device: Optional[torch.device] = None,
):
  """cc3d-equivalent block CCL. labels: (x, y, z) any integer dtype.

  Returns components renumbered 1..N in order of each component's first
  voxel in Fortran (x-fastest) scan order; 0 stays background.
  Deterministic across recomputation, which the 4-pass CCL protocol needs.
  ``device`` overrides the port's device (the skeleton task labels its
  small boundary planes on the CPU).
  """
  if labels.ndim != 3:
    raise ValueError("labels must be (x, y, z)")
  neighbor_offsets(connectivity)
  if labels.size == 0:
    out = np.zeros(labels.shape, dtype=np.uint32)
    return (out, 0) if return_N else out

  with telemetry.stage("dense_relabel"):
    lab32 = _dense_relabel(labels)
    # device layout (z, y, x): x innermost
    zyx = np.ascontiguousarray(lab32.transpose(2, 1, 0))
  roots = _ccl_tiled(zyx, connectivity, device).transpose(2, 1, 0)
  with telemetry.stage("renumber"):
    out = _roots_to_components(roots)
    N = int(out.max())
  return (out, N) if return_N else out


def _batch_executor(connectivity: int):
  """The ``BatchKernelExecutor`` of the tiled resolve over a (K, z, y, x)
  int32 batch: one ``tile_resolve`` launch for all K."""
  from ..parallel.executor import BatchKernelExecutor

  return BatchKernelExecutor(
    partial(_ccl_tiled_roots, connectivity=connectivity, tile=_tile_shape())
  )


def connected_components_batch(
  labels_batch: np.ndarray, connectivity: int = 6, executor=None
):
  """Batched block CCL: (K, x, y, z) -> list of K component volumes, each
  numbered exactly as ``connected_components`` numbers it alone. The tile
  resolve of all K cutouts is one launch; the merge and the renumbering
  stay per cutout on the host."""
  labels_batch = np.asarray(labels_batch)
  if labels_batch.ndim != 4:
    raise ValueError("labels_batch must be (K, x, y, z)")
  neighbor_offsets(connectivity)
  if executor is None:
    executor = _batch_executor(connectivity)
  with telemetry.stage("dense_relabel"):
    lab32 = _dense_relabel(labels_batch)
    zyx = np.ascontiguousarray(lab32.transpose(0, 3, 2, 1))  # (K, z, y, x)
  roots = executor(zyx)
  tile = _tile_shape(executor.device)
  out = []
  for k in range(len(zyx)):
    with telemetry.stage("tile_merge"):
      merged = _merge_tile_roots(roots[k], zyx[k], connectivity, tile)
    with telemetry.stage("renumber"):
      out.append(_roots_to_components(merged.transpose(2, 1, 0)))
  return out


def dust(
  labels: np.ndarray, threshold: int, connectivity: int = 6,
  in_place: bool = False,
) -> np.ndarray:
  """cc3d.dust parity: zero out connected components smaller than
  ``threshold`` voxels. Components are per label (touching distinct labels
  stay distinct components)."""
  if threshold <= 0:
    return labels
  cc = connected_components(labels, connectivity=connectivity)
  counts = np.bincount(cc.ravel())
  small = counts < int(threshold)
  small[0] = False  # background is never dusted
  if not in_place:
    labels = labels.copy()
  labels[small[cc]] = 0
  return labels


def _dense_relabel(labels: np.ndarray) -> np.ndarray:
  """Compress any integer dtype to int32 dense ids for the device kernel
  (multilabel equality only needs label identity). Background zero keeps
  dense id 0; every real label gets a positive id — including when signed
  inputs sort negatives before zero, or when zero is absent entirely.

  The ids are the ranks of np.unique(labels, return_inverse=True), found
  as a unique then a binary search: the same array, without the argsort of
  every voxel that return_inverse does (several times faster on a task's
  cutout). A Fortran-ordered input gives a Fortran-ordered output, so its
  (z, y, x) transpose is C-contiguous."""
  uniq = np.unique(labels)
  order = "F" if labels.flags.f_contiguous else "C"
  lab32 = np.searchsorted(uniq, labels.reshape(-1, order=order)).astype(np.int32)
  lab32 = lab32.reshape(labels.shape, order=order)
  if not np.any(uniq == 0):
    # no zero present: keep everything foreground (checking membership,
    # not uniq[0] — signed inputs can sort negatives before zero)
    lab32 = lab32 + 1
  elif uniq[0] != 0:
    # zero present but not first (negative labels): make zero's dense id 0
    zero_pos = int(np.searchsorted(uniq, 0))
    lab32 = np.where(
      lab32 == zero_pos, 0, np.where(lab32 < zero_pos, lab32 + 1, lab32)
    ).astype(np.int32)
  return lab32


def _roots_to_components(roots: np.ndarray) -> np.ndarray:
  """Root flat indices (x, y, z) -> components renumbered 1..N in Fortran
  (x-fastest) first-appearance order; background (sentinel) stays 0."""
  fg = roots != _BIG
  if not fg.any():
    return np.zeros(roots.shape, dtype=np.uint32)
  flat_f = roots.reshape(-1, order="F")
  fg_f = fg.reshape(-1, order="F")
  seen, first_pos = np.unique(flat_f[fg_f], return_index=True)
  order = np.argsort(first_pos, kind="stable")
  rank = np.empty(len(seen), dtype=np.uint32)
  rank[order] = np.arange(1, len(seen) + 1, dtype=np.uint32)
  comp = rank[np.searchsorted(seen, flat_f[fg_f])]
  out_f = np.zeros(flat_f.shape, dtype=np.uint32)
  out_f[fg_f] = comp
  return out_f.reshape(roots.shape, order="F")


def threshold_image(
  img: np.ndarray,
  threshold_gte: Optional[float] = None,
  threshold_lte: Optional[float] = None,
) -> np.ndarray:
  """Grayscale -> binary foreground (uint8 0/1)."""
  if threshold_gte is None and threshold_lte is None:
    return img
  fg = np.ones(img.shape, dtype=bool)
  if threshold_gte is not None:
    fg &= img >= threshold_gte
  if threshold_lte is not None:
    fg &= img <= threshold_lte
  return fg.astype(np.uint8)


class DisjointSet:
  """Path-compressed union-find over arbitrary int labels (the global merge
  of the 4-pass protocol)."""

  def __init__(self):
    self.parent = {}

  def makeset(self, x: int):
    if x not in self.parent:
      self.parent[x] = x

  def find(self, x: int) -> int:
    self.makeset(x)
    root = x
    while self.parent[root] != root:
      root = self.parent[root]
    while self.parent[x] != root:  # path compression
      self.parent[x], x = root, self.parent[x]
    return root

  def union(self, x: int, y: int):
    rx, ry = self.find(x), self.find(y)
    if rx != ry:
      if rx > ry:
        rx, ry = ry, rx
      self.parent[ry] = rx

  def renumber(self, start: int = 1):
    """{label: dense component id} over every seen label."""
    out = {}
    next_id = {}
    counter = start
    for x in sorted(self.parent):
      r = self.find(x)
      if r not in next_id:
        next_id[r] = counter
        counter += 1
      out[x] = next_id[r]
    return out, counter - 1
