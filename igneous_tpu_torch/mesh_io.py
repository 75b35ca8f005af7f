"""Mesh container, the Precomputed mesh codec and simplification.

The port's own copy of the parts of ``igneous_tpu/mesh_io.py`` that the
legacy meshing path uses: ``Mesh`` with its Precomputed codec, and
``simplify`` with the native quadric edge collapse (``csrc/simplify.cpp``,
built with g++ by ``ops/_build.py``), and the ``FragMap`` container,
trimmed to what the voxel-count census writes and reads. Draco and the
sharded ``.frags`` output are not ported yet. Unlike the JAX package, a simplifier library that does
not build raises instead of falling back to vertex clustering; clustering
runs only when asked for (``placement="centroid"``) or where the JAX
package's own algorithm takes it (a collapse that leaves no face).
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np


def drop_degenerate_faces(faces: np.ndarray) -> np.ndarray:
  """Remove faces that reference the same vertex index twice."""
  ok = (
    (faces[:, 0] != faces[:, 1])
    & (faces[:, 1] != faces[:, 2])
    & (faces[:, 0] != faces[:, 2])
  )
  return faces[ok]


class Mesh:
  """Triangle mesh: vertices (V,3) float32 physical units, faces (F,3) uint32."""

  def __init__(self, vertices: np.ndarray, faces: np.ndarray):
    self.vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    self.faces = np.asarray(faces, dtype=np.uint32).reshape(-1, 3)

  def __len__(self) -> int:
    return len(self.vertices)

  def __eq__(self, other) -> bool:
    return (
      isinstance(other, Mesh)
      and np.array_equal(self.vertices, other.vertices)
      and np.array_equal(self.faces, other.faces)
    )

  def clone(self) -> "Mesh":
    return Mesh(self.vertices.copy(), self.faces.copy())

  @classmethod
  def concatenate(cls, *meshes: "Mesh") -> "Mesh":
    if not meshes:
      return cls(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32))
    verts = []
    faces = []
    voff = 0
    for m in meshes:
      verts.append(m.vertices)
      faces.append(m.faces + np.uint32(voff))
      voff += len(m.vertices)
    return cls(np.concatenate(verts), np.concatenate(faces))

  def consolidate(self) -> "Mesh":
    """Weld duplicate vertices and drop degenerate faces."""
    if len(self.vertices) == 0:
      return self.clone()
    uniq, inverse = np.unique(self.vertices, axis=0, return_inverse=True)
    faces = inverse[self.faces.astype(np.int64)].astype(np.uint32)
    return Mesh(uniq, drop_degenerate_faces(faces))

  def to_precomputed(self) -> bytes:
    """Neuroglancer legacy mesh: uint32le V, float32le xyz*V, uint32le faces."""
    return (
      struct.pack("<I", len(self.vertices))
      + self.vertices.astype("<f4").tobytes()
      + self.faces.astype("<u4").tobytes()
    )

  @classmethod
  def from_precomputed(cls, data: bytes) -> "Mesh":
    (nverts,) = struct.unpack("<I", data[:4])
    vend = 4 + nverts * 12
    vertices = np.frombuffer(data[4:vend], dtype="<f4").reshape(-1, 3)
    faces = np.frombuffer(data[vend:], dtype="<u4").reshape(-1, 3)
    return cls(vertices.copy(), faces.copy())


def _check_encoding(encoding: str) -> None:
  if encoding == "draco":
    raise NotImplementedError(
      "draco mesh encoding is not ported to igneous_tpu_torch yet; "
      "use encoding='precomputed'"
    )
  if encoding != "precomputed":
    raise ValueError(f"Unknown mesh encoding: {encoding}")


def encode_mesh(mesh: Mesh, encoding: str = "precomputed") -> bytes:
  _check_encoding(encoding)
  return mesh.to_precomputed()


def decode_mesh(data: bytes, encoding: str = "precomputed") -> Mesh:
  _check_encoding(encoding)
  return Mesh.from_precomputed(data)


# ---------------------------------------------------------------------------
# simplification


def simplify(
  mesh: Mesh,
  reduction_factor: float = 100.0,
  max_error: float = 40.0,
  max_iters: int = 8,
  placement: str = "qem",
) -> Mesh:
  """Mesh simplification toward ``faces/reduction_factor`` faces without
  exceeding ``max_error`` physical-units geometric deviation.

  * ``placement="qem"`` (default): the native priority-queue QEM edge
    collapse (``csrc/simplify.cpp``): area-weighted Garland-Heckbert
    quadrics, optimal vertex placement, border constraints, link-condition
    and flip rejection. Collapsing stops once the cheapest collapse's
    summed quadric cost exceeds ``max_error**2``. The library builds with
    g++ at first use; a failed build raises.
  * ``placement="centroid"``: vectorized vertex clustering with the cell
    size capped at ``max_error``.
  """
  if placement not in ("qem", "centroid"):
    raise ValueError(f"placement must be 'qem' or 'centroid': {placement!r}")
  if len(mesh.faces) == 0 or reduction_factor <= 1:
    return mesh.clone()

  target_faces = max(int(len(mesh.faces) / reduction_factor), 4)

  if placement == "qem":
    out = _native_collapse(mesh, target_faces, max_error)
    if out is not None:
      return out
  extent = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
  hi_cell = float(max(extent.max(), 1.0))
  if max_error is not None and max_error > 0:
    hi_cell = min(hi_cell, float(max_error))

  # quadrics depend only on the input mesh: build once for every
  # cell-bisection iteration
  Qv = _vertex_quadrics(mesh) if placement == "qem" else None
  best = mesh
  cell = hi_cell
  for _ in range(max_iters):
    m = _cluster_collapse(mesh, cell, placement=placement, Qv=Qv)
    if len(m.faces) >= target_faces or cell >= hi_cell:
      best = m
    if len(m.faces) < target_faces:
      cell *= 0.5
    else:
      break
  return best if len(best.faces) > 0 else mesh.clone()


_SIMPLIFY_LOCK = threading.Lock()


def simplify_lib() -> ctypes.CDLL:
  """The simplifier library, built with g++ on first use (raises if it
  does not build)."""
  from .ops import _build

  lib = _build.load("simplify")
  with _SIMPLIFY_LOCK:
    if not getattr(lib, "_configured", False):
      lib.igsimp_simplify.restype = ctypes.c_int
      lib.igsimp_simplify.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
      ]
      lib._configured = True
  return lib


def _native_collapse(
  mesh: Mesh, target_faces: int, max_error, preserve_border: bool = True
) -> "Mesh | None":
  """Priority-queue QEM edge collapse via csrc/simplify.cpp. None only
  where the collapse leaves no face, and the caller then clusters, as the
  JAX package does."""
  lib = simplify_lib()
  v = np.ascontiguousarray(mesh.vertices, dtype=np.float32)
  f = np.ascontiguousarray(mesh.faces, dtype=np.uint32)
  vout = np.empty_like(v)
  fout = np.empty_like(f)
  out_nv = ctypes.c_int64(0)
  out_nf = ctypes.c_int64(0)
  rc = lib.igsimp_simplify(
    v.ctypes.data_as(ctypes.c_void_p), len(v),
    f.ctypes.data_as(ctypes.c_void_p), len(f),
    int(target_faces),
    float(max_error) if max_error is not None and max_error > 0 else -1.0,
    1 if preserve_border else 0,
    vout.ctypes.data_as(ctypes.c_void_p),
    fout.ctypes.data_as(ctypes.c_void_p),
    ctypes.byref(out_nv), ctypes.byref(out_nf),
  )
  if rc != 0:
    raise RuntimeError(f"igsimp_simplify failed with code {rc}")
  if out_nf.value <= 0:
    return None
  return Mesh(vout[: out_nv.value].copy(), fout[: out_nf.value].copy())


def _vertex_quadrics(mesh: Mesh) -> np.ndarray:
  """Per-vertex 4x4 error quadrics: the sum of the squared-distance
  quadrics of every incident face plane (Garland-Heckbert)."""
  v = mesh.vertices.astype(np.float64)
  f = mesh.faces.astype(np.int64)
  p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
  n = np.cross(p1 - p0, p2 - p0)
  norm = np.linalg.norm(n, axis=1, keepdims=True)
  n = np.divide(n, norm, out=np.zeros_like(n), where=norm > 1e-12)
  d = -np.einsum("ij,ij->i", n, p0)
  plane = np.concatenate([n, d[:, None]], axis=1)  # (F, 4)
  K = plane[:, :, None] * plane[:, None, :]  # (F, 4, 4)
  Q = np.zeros((len(v), 4, 4), dtype=np.float64)
  for corner in range(3):
    np.add.at(Q, f[:, corner], K)
  return Q


def _cluster_collapse(
  mesh: Mesh, cell: float, placement: str = "qem", Qv=None
) -> Mesh:
  keys = np.floor(mesh.vertices / max(cell, 1e-6)).astype(np.int64)
  uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
  nclusters = len(uniq)
  sums = np.zeros((nclusters, 3), dtype=np.float64)
  np.add.at(sums, inverse, mesh.vertices)
  counts = np.bincount(inverse, minlength=nclusters).astype(np.float64)
  centroids = sums / counts[:, None]

  if placement == "qem" and len(mesh.faces):
    # place each cluster's vertex at the point minimizing the summed
    # quadric error of its members' face planes
    if Qv is None:
      Qv = _vertex_quadrics(mesh)
    Qc = np.zeros((nclusters, 4, 4), dtype=np.float64)
    np.add.at(Qc, inverse, Qv)
    A = Qc[:, :3, :3]
    b = -Qc[:, :3, 3]
    placed = centroids.copy()
    # batch-solve the well-conditioned systems; singular ones (flat or
    # degenerate neighborhoods) keep the centroid
    dets = np.abs(np.linalg.det(A))
    scale = np.maximum(np.abs(A).sum(axis=(1, 2)), 1e-12) ** 3
    good = dets > 1e-10 * scale
    if good.any():
      sol = np.linalg.solve(A[good], b[good][..., None])[..., 0]
      # reject wild extrapolations outside the cluster cell
      near = np.all(np.abs(sol - centroids[good]) <= 2.0 * cell, axis=1)
      idx = np.flatnonzero(good)[near]
      placed[idx] = sol[near]
    centroids = placed

  faces = inverse[mesh.faces.astype(np.int64)].astype(np.uint32)
  return Mesh(centroids.astype(np.float32), drop_degenerate_faces(faces))


# ---------------------------------------------------------------------------
# FragMap: the uint64 -> bytes container of ``voxel_counts.im``


class FragMap:
  """Zero-parse random-access uint64 -> bytes container (the mapbuffer
  equivalent; the JAX package's ``mesh_io.FragMap``, trimmed to
  ``tobytes``, ``frombytes`` and ``get``). Layout (little endian):
    magic b'IGFM' | uint32 version | uint64 N
    uint64 keys[N] (sorted) | uint64 offsets[N+1] (into blob section)
    blobs
  Lookups binary-search the key table; nothing else is parsed.
  """

  MAGIC = b"IGFM"

  def __init__(self, data: bytes):
    if data[:4] != self.MAGIC:
      raise ValueError("not a FragMap")
    self._data = data
    (self._n,) = struct.unpack_from("<Q", data, 8)
    ko = 16
    self._keys = np.frombuffer(data, dtype="<u8", count=self._n, offset=ko)
    self._offsets = np.frombuffer(
      data, dtype="<u8", count=self._n + 1, offset=ko + 8 * self._n
    )
    self._blob0 = ko + 8 * self._n + 8 * (self._n + 1)

  @classmethod
  def frombytes(cls, data: bytes) -> "FragMap":
    return cls(data)

  @classmethod
  def tobytes(cls, mapping) -> bytes:
    keys = sorted(mapping.keys())
    blobs = [mapping[k] for k in keys]
    offsets = np.zeros(len(keys) + 1, dtype="<u8")
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return b"".join([
      cls.MAGIC,
      struct.pack("<I", 1),
      struct.pack("<Q", len(keys)),
      np.asarray(keys, dtype="<u8").tobytes(),
      offsets.tobytes(),
      *blobs,
    ])

  def __len__(self) -> int:
    return int(self._n)

  def get(self, key: int):
    """The bytes stored under ``key``, or None."""
    i = int(np.searchsorted(self._keys, np.uint64(key)))
    if i >= self._n or self._keys[i] != np.uint64(key):
      return None
    a = self._blob0 + int(self._offsets[i])
    b = self._blob0 + int(self._offsets[i + 1])
    return self._data[a:b]
