"""Chunk encodings for Precomputed volumes: ``raw`` only, for now.

The port's own copy of the ``raw`` codec of ``igneous_tpu/codecs.py``.
In-memory chunks are (x, y, z, c) arrays; ``raw`` stores them
Fortran-ordered (x fastest, channel slowest), the Precomputed "raw" spec.
compressed_segmentation, jpeg, png and compresso are not ported yet.
"""

from __future__ import annotations

import numpy as np

_NOT_PORTED = (
  "encoding {!r} is not ported to igneous_tpu_torch yet "
  "(ROADMAP.md, modules still to port: codecs); use raw"
)


def encode_raw(img: np.ndarray) -> bytes:
  # consolidating a strided view to F-order first keeps the encode at copy
  # speed; the bytes are identical either way
  if not img.flags.f_contiguous:
    img = np.asfortranarray(img)
  return img.tobytes("F")


def decode_raw(data: bytes, shape, dtype) -> np.ndarray:
  """A read-only (x, y, z, c) view of ``data``; callers copy the voxels."""
  return np.frombuffer(data, dtype=dtype).reshape(shape, order="F")


def encode(img: np.ndarray, encoding: str) -> bytes:
  if img.ndim == 3:
    img = img[..., np.newaxis]
  if encoding == "raw":
    return encode_raw(img)
  raise NotImplementedError(_NOT_PORTED.format(encoding))


def decode(data: bytes, encoding: str, shape, dtype) -> np.ndarray:
  shape = tuple(int(v) for v in shape)
  if len(shape) == 3:
    shape = shape + (1,)
  if encoding == "raw":
    return decode_raw(data, shape, dtype)
  raise NotImplementedError(_NOT_PORTED.format(encoding))
