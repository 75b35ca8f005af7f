"""In-RAM compressed label volumes with lazy per-label access.

The port's own copy of ``igneous_tpu/compressed.py``: a label cutout held
as the port's compressed_segmentation stream (``cseg``), whose block
tables give random access, so a per-label mask decodes only the blocks of
that label's bounding box. The low-memory cross-section path of
``SkeletonTask`` uses it. The bounding boxes come from the device
(``ops.mesh.label_bboxes``), the same slices as ``ndimage.find_objects``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from . import cseg


class CompressedLabels:
  """One label cutout, cseg-compressed in RAM.

  Construction makes a single pass to record per-label bounding boxes,
  then holds only the compressed payload (typically 5-50x smaller than
  raw for segmentation). ``mask(label)`` and ``each()`` decode O(label
  bbox) voxels via cseg's block random access.
  """

  def __init__(self, labels: np.ndarray, block_size=(8, 8, 8)):
    if labels.ndim != 3:
      raise ValueError("labels must be (x, y, z)")
    self.shape = tuple(int(s) for s in labels.shape)
    self.dtype = labels.dtype
    self.block_size = tuple(int(b) for b in block_size)
    self._payload = cseg.compress(labels[..., None], self.block_size)

    from .ops.mesh import label_bboxes

    self._bboxes: Dict[int, Tuple[slice, slice, slice]] = {
      k: sl for k, sl in label_bboxes(labels).items() if k != 0
    }

  @property
  def nbytes(self) -> int:
    return len(self._payload)

  @property
  def raw_nbytes(self) -> int:
    return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize

  def labels(self):
    return sorted(self._bboxes.keys())

  def bbox(self, label: int) -> Optional[Tuple[slice, slice, slice]]:
    return self._bboxes.get(int(label))

  def decompress(self) -> np.ndarray:
    return cseg.decompress(
      self._payload, self.shape + (1,), self.dtype, self.block_size
    )[..., 0]

  def region(self, lo, hi) -> np.ndarray:
    return cseg.decompress_region(
      self._payload, self.shape + (1,), self.dtype, lo, hi,
      self.block_size,
    )

  def mask(self, label: int, margin: int = 0):
    """(bool mask over the label's bbox + margin, (lo offset)) or None.

    Decodes only the covering blocks — the low-memory per-label path."""
    sl = self._bboxes.get(int(label))
    if sl is None:
      return None
    lo = [max(0, s.start - margin) for s in sl]
    hi = [min(d, s.stop + margin) for s, d in zip(sl, self.shape)]
    region = self.region(lo, hi)
    return region == np.asarray(label, dtype=self.dtype), tuple(lo)

  def each(self, labels=None) -> Iterator:
    """Yield (label, mask, lo_offset) lazily."""
    for label in (labels if labels is not None else self.labels()):
      got = self.mask(int(label))
      if got is None:
        continue
      mask, lo = got
      yield int(label), mask, lo
