"""Multilabel morphology: dilation and erosion on the device, hole
filling on the host.

The port's own copy of ``igneous_tpu/ops/morphology.py``. The JAX
package's dilation step is an XLA program (``_dilate_kernel``); here it is
``dilate_step``, torch operations on a (z, y, x) int32 tensor, so the same
code runs on the card and, in the tests, on the CPU. The erosion runs on
the device the same way. ``fill_holes`` stays a host flood fill per label
box (scipy), as in the JAX package; its level 3 closes cracks with a
dilation and an erosion first. Every output equals the JAX package's bit
for bit.

Stage timers (``telemetry``): dilate and erode (the device work with its
copies; each ends in a copy to the host), fill_holes (the host flood
fill).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from .. import telemetry
from ..device import get_device
from .mesh import labels_on_device, unique_on_device
from .remap import renumber

# the six face neighbours of a voxel of a (z, y, x) tensor padded by one,
# in the JAX package's tie order -z, +z, -y, +y, -x, +x: its jnp.roll by +1
# along an axis reads the lower neighbour, by -1 the upper one
_NEIGHBOURS = (
  (slice(None, -2), slice(1, -1), slice(1, -1)),
  (slice(2, None), slice(1, -1), slice(1, -1)),
  (slice(1, -1), slice(None, -2), slice(1, -1)),
  (slice(1, -1), slice(2, None), slice(1, -1)),
  (slice(1, -1), slice(1, -1), slice(None, -2)),
  (slice(1, -1), slice(1, -1), slice(2, None)),
)


def _neighbours(labels: torch.Tensor):
  """The six face-neighbour views of ``labels``, 0 outside the array."""
  padded = F.pad(labels, (1, 1, 1, 1, 1, 1))
  return [padded[sl] for sl in _NEIGHBOURS]


def dilate_step(labels: torch.Tensor) -> torch.Tensor:
  """One 6-connected multilabel dilation step of (z, y, x) int32 labels.

  A background voxel takes the most frequent nonzero label among its six
  face neighbours; ties go to the first in the order -z, +z, -y, +y, -x,
  +x (the score ``count * 6 - i``); foreground voxels are unchanged."""
  shifts = _neighbours(labels)
  n = len(shifts)
  # each neighbour equals itself; the 15 pairs count for both sides
  counts = [torch.ones(labels.shape, dtype=torch.int8, device=labels.device)
            for _ in range(n)]
  for i in range(n):
    for j in range(i + 1, n):
      eq = shifts[i] == shifts[j]
      counts[i] += eq
      counts[j] += eq
  best_v = torch.zeros_like(labels)
  best_s = torch.full(labels.shape, -1, dtype=torch.int8, device=labels.device)
  for i in range(n):
    score = torch.where(shifts[i] != 0, counts[i] * n - i, -1)
    take = score > best_s
    best_s = torch.where(take, score, best_s)
    best_v = torch.where(take, shifts[i], best_v)
  return torch.where(labels != 0, labels, best_v)


def erode_step(labels: torch.Tensor) -> torch.Tensor:
  """One multilabel erosion step of (z, y, x) labels: a voxel keeps its
  label only if all six face neighbours share it (outside the array is
  background)."""
  keep = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
  for nb in _neighbours(labels):
    keep &= nb == labels
  return labels.masked_fill(~keep, 0)


def _to_host(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
  """(z, y, x) int64 on the device -> (x, y, z) numpy of ``dtype`` (uint64
  as the same bits)."""
  host = t.cpu().numpy()
  host = host.view(np.uint64) if dtype == np.uint64 else host.astype(dtype)
  return host.transpose(2, 1, 0)


def dilate(labels: np.ndarray, iterations: int = 1) -> np.ndarray:
  """Multilabel 6-connected dilation of (x, y, z) integer labels, each
  step ``dilate_step`` on the device."""
  if labels.ndim != 3:
    raise ValueError("labels must be (x, y, z)")
  dev = get_device()
  with telemetry.stage("dilate"):
    uniq, inverse = unique_on_device(labels, dev, return_inverse=True)
    dense = inverse.to(torch.int32)
    del inverse
    if uniq[0] != 0:
      # dense id 0 must be background: shift, and keep uniq's dtype (a
      # bare [0] would promote uint64 to float64)
      dense += 1
      uniq = np.concatenate([np.zeros(1, dtype=uniq.dtype), uniq])
    for _ in range(int(iterations)):
      dense = dilate_step(dense)
    table = uniq.view(np.int64) if uniq.dtype == np.uint64 else uniq.astype(np.int64)
    out = torch.from_numpy(table).to(dev)[dense.long()]
    del dense
    return _to_host(out, labels.dtype)


def erode(labels: np.ndarray, iterations: int = 1) -> np.ndarray:
  """Multilabel erosion of (x, y, z) integer labels on the device: a voxel
  keeps its label only if all 6 neighbors share it (array borders count
  as background)."""
  if labels.dtype.kind not in "biu":
    raise ValueError(f"labels must be integers, not {labels.dtype}")
  dev = get_device()
  with telemetry.stage("erode"):
    seg, _ = labels_on_device(labels, (0, 0, 0), (0, 0, 0), dev)
    for _ in range(int(iterations)):
      seg = erode_step(seg)
    return _to_host(seg, labels.dtype)


def fill_holes(
  labels: np.ndarray,
  return_fill_count: bool = False,
  level: int = 1,
):
  """Fill cavities fully enclosed by a single label (fastmorph fill_holes
  semantics, host flood fill per label).

  Levels follow the MeshTask ladder of Igneous:
    1  fill enclosed cavities;
    2  same as 1 here (the cross-border repair needs the neighbour task's
       context, which this local operation does not have);
    3+ morphological closing first (dilate, fill, erode) so thin cracks
       into a cavity do not keep it open.
  """
  if level >= 3:
    grown = dilate(labels)
    filled = fill_holes(grown, level=1)
    closed = erode(filled)
    with telemetry.stage("fill_holes"):
      # closing may erase 1-voxel-thin structures: restore the originals
      closed = np.where(labels != 0, labels, closed).astype(labels.dtype)
      if return_fill_count:
        add = (closed != 0) & (labels == 0)
        vals, counts = np.unique(closed[add], return_counts=True)
        return closed, {int(v): int(c) for v, c in zip(vals, counts)}
      return closed
  with telemetry.stage("fill_holes"):
    out = labels.copy()
    fill_counts = {}
    # crop each label to its bbox: O(sum of label extents), not O(L x V)
    dense, mapping = renumber(labels)
    for new_id, sl in enumerate(
      ndimage.find_objects(dense.astype(np.int32)), start=1
    ):
      if sl is None:
        continue
      v = mapping[new_id]
      sub_mask = dense[sl] == new_id
      filled = ndimage.binary_fill_holes(sub_mask)
      add = filled & ~sub_mask & (out[sl] == 0)  # true background cavities only
      if add.any():
        out[sl][add] = v
        fill_counts[int(v)] = int(add.sum())
  if return_fill_count:
    return out, fill_counts
  return out
