"""Geometry primitives: integer vectors, bounding boxes, and grid math.

The port's own copy of ``igneous_tpu/lib.py``, trimmed to what the
downsample, connected-components and meshing paths use.

Conventions:
  - All voxel coordinates are (x, y, z) triples.
  - ``Bbox`` is half-open: [minpt, maxpt).
  - Chunk/grid alignment helpers take an ``offset`` (the volume's voxel_offset)
    because Precomputed chunk grids are anchored at the voxel offset, not 0.
"""

from __future__ import annotations

import re
from typing import Iterator, Sequence, Union

import numpy as np

VecLike = Union[Sequence[int], Sequence[float], np.ndarray, "Vec"]


class Vec(np.ndarray):
  """A small numpy vector with .x/.y/.z accessors (always a 1-D array)."""

  def __new__(cls, *args, dtype=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple, np.ndarray)):
      args = tuple(args[0])
    if dtype is None:
      dtype = np.float64 if any(isinstance(a, float) for a in args) else np.int64
    return np.asarray(args, dtype=dtype).view(cls)

  @property
  def x(self):
    return self[0]

  @property
  def y(self):
    return self[1]

  @property
  def z(self):
    return self[2]

  def clone(self) -> "Vec":
    return Vec(*self)

  # Vec is a coordinate type: == / != compare whole coordinates (bool), so
  # Vecs work as dict/set keys. Use np.asarray(v) first for elementwise math.
  def __eq__(self, other):  # type: ignore[override]
    return bool(np.array_equal(np.asarray(self), np.asarray(other)))

  def __ne__(self, other):  # type: ignore[override]
    return not self.__eq__(other)

  def __hash__(self):  # type: ignore[override]
    return hash(tuple(self))


def ceil_div(a, b) -> np.ndarray:
  a = np.asarray(a, dtype=np.int64)
  b = np.asarray(b, dtype=np.int64)
  return -(-a // b)


class Bbox:
  """Half-open integer bounding box [minpt, maxpt) in voxel coordinates."""

  __slots__ = ("minpt", "maxpt", "dtype")

  _FILENAME_RE = re.compile(r"(-?\d+)-(-?\d+)_(-?\d+)-(-?\d+)_(-?\d+)-(-?\d+)")

  def __init__(self, minpt: VecLike, maxpt: VecLike, dtype=np.int64):
    self.minpt = Vec(*minpt, dtype=dtype)
    self.maxpt = Vec(*maxpt, dtype=dtype)
    self.dtype = dtype

  @classmethod
  def from_list(cls, lst: Sequence[int]) -> "Bbox":
    n = len(lst) // 2
    return cls(lst[:n], lst[n:])

  @classmethod
  def from_filename(cls, filename: str) -> "Bbox":
    """Parse the Precomputed chunk-name convention ``x0-x1_y0-y1_z0-z1``."""
    m = cls._FILENAME_RE.search(filename)
    if m is None:
      raise ValueError(f"Not a chunk filename: {filename}")
    g = [int(v) for v in m.groups()]
    return cls((g[0], g[2], g[4]), (g[1], g[3], g[5]))

  # -- geometry -------------------------------------------------------------

  def size3(self) -> Vec:
    return Vec(*(self.maxpt - self.minpt))

  def empty(self) -> bool:
    return bool(np.any(self.maxpt <= self.minpt))

  def clone(self) -> "Bbox":
    return Bbox(self.minpt, self.maxpt, dtype=self.dtype)

  def contains_bbox(self, other: "Bbox") -> bool:
    return bool(
      np.all(other.minpt >= self.minpt) and np.all(other.maxpt <= self.maxpt)
    )

  @classmethod
  def intersection(cls, a: "Bbox", b: "Bbox") -> "Bbox":
    mn = np.maximum(a.minpt, b.minpt)
    mx = np.minimum(a.maxpt, b.maxpt)
    mx = np.maximum(mn, mx)
    return cls(mn, mx)

  @classmethod
  def intersects(cls, a: "Bbox", b: "Bbox") -> bool:
    return not cls.intersection(a, b).empty()

  @classmethod
  def expand(cls, *boxes: "Bbox") -> "Bbox":
    mn = np.min([b.minpt for b in boxes], axis=0)
    mx = np.max([b.maxpt for b in boxes], axis=0)
    return cls(mn, mx)

  # scaling between mips
  def __truediv__(self, factor) -> "Bbox":
    f = np.asarray(factor)
    return Bbox(self.minpt // f, ceil_div(self.maxpt, f))

  def __mul__(self, factor) -> "Bbox":
    f = np.asarray(factor)
    return Bbox(self.minpt * f, self.maxpt * f)

  def clamp(self, other: "Bbox") -> "Bbox":
    return Bbox.intersection(self, other)

  def translate(self, delta: VecLike) -> "Bbox":
    d = Vec(*delta)
    return Bbox(self.minpt + d, self.maxpt + d)

  # -- chunk alignment ------------------------------------------------------

  def expand_to_chunk_size(self, chunk_size: VecLike, offset: VecLike = (0, 0, 0)) -> "Bbox":
    cs = np.asarray(chunk_size, dtype=np.int64)
    off = np.asarray(offset, dtype=np.int64)
    mn = (self.minpt - off) // cs * cs + off
    mx = ceil_div(self.maxpt - off, cs) * cs + off
    return Bbox(mn, mx)

  # -- conversions ----------------------------------------------------------

  def to_filename(self) -> str:
    return "_".join(
      f"{int(a)}-{int(b)}" for a, b in zip(self.minpt, self.maxpt)
    )

  def to_list(self):
    return [int(v) for v in self.minpt] + [int(v) for v in self.maxpt]

  # -- dunder ---------------------------------------------------------------

  def __eq__(self, other) -> bool:
    if not isinstance(other, Bbox):
      return NotImplemented
    return bool(
      np.array_equal(self.minpt, other.minpt)
      and np.array_equal(self.maxpt, other.maxpt)
    )

  def __hash__(self):
    return hash(tuple(self.to_list()))

  def __repr__(self):
    return f"Bbox({list(map(int, self.minpt))}, {list(map(int, self.maxpt))})"


def xyzrange(start, stop=None, step=None) -> Iterator[Vec]:
  """Iterate integer grid coordinates in Fortran order (x fastest)."""
  if stop is None:
    start, stop = np.zeros(len(tuple(start)), dtype=np.int64), start
  start = np.asarray(start, dtype=np.int64)
  stop = np.asarray(stop, dtype=np.int64)
  if step is None:
    step = np.ones_like(start)
  step = np.asarray(step, dtype=np.int64)

  rngs = [range(int(a), int(b), int(s)) for a, b, s in zip(start, stop, step)]
  # x varies fastest to mirror chunk-file enumeration order
  for z in rngs[2]:
    for y in rngs[1]:
      for x in rngs[0]:
        yield Vec(x, y, z)


def chunk_bboxes(
  bounds: Bbox,
  chunk_size: VecLike,
  offset: VecLike = (0, 0, 0),
  clamp: bool = True,
) -> Iterator[Bbox]:
  """Enumerate grid-aligned chunk bboxes covering ``bounds``."""
  cs = Vec(*chunk_size)
  aligned = bounds.expand_to_chunk_size(cs, offset)
  for pt in xyzrange(aligned.minpt, aligned.maxpt, cs):
    bbx = Bbox(pt, pt + cs)
    if clamp:
      bbx = Bbox.intersection(bbx, bounds)
    if not bbx.empty():
      yield bbx


def jsonify(obj) -> object:
  """Recursively convert numpy scalars/arrays to JSON-safe python types."""
  if isinstance(obj, dict):
    return {k: jsonify(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [jsonify(v) for v in obj]
  if isinstance(obj, np.ndarray):
    return [jsonify(v) for v in obj.tolist()]
  if isinstance(obj, np.integer):
    return int(obj)
  if isinstance(obj, np.floating):
    return float(obj)
  if isinstance(obj, bytes):
    return obj.decode("utf8")
  return obj
