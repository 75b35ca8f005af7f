"""Multi-resolution (LOD) mesh format: octree chunking + manifests.

The port's own copy of ``igneous_tpu/mesh_multires.py``, numpy on the
host as there, writing the same bytes. It produces the Neuroglancer
``neuroglancer_multilod_draco`` structures: a per-label manifest (chunk
grid, lod scales, fragment positions and sizes) and per-LOD octree
fragments. Fragment payloads are draco bitstreams (``mesh_io``'s draco
hook, by default the port's ``draco`` module), quantized per fragment so
that the lattice spans the fragment's octree cell: the contract
Neuroglancer's multires renderer consumes. Every float step keeps the JAX
package's order (the lattice in float64, cast to float32 once), and the
LOD pyramid runs the port's ``simplify``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mesh_io import Mesh, encode_mesh, simplify
from .sharding import compressed_morton_code


def to_stored_lattice(
  vertices: np.ndarray,
  cell_origin: np.ndarray,
  cell_size: np.ndarray,
  vertex_quantization_bits: int,
) -> np.ndarray:
  """Transform model-space vertices into Neuroglancer's stored-model
  lattice for one multires fragment: per-axis, the fragment's octree cell
  maps onto [0, 2**vertex_quantization_bits]. This is the coordinate
  system the multires renderer consumes."""
  scale = float(1 << vertex_quantization_bits) / np.asarray(cell_size, np.float64)
  return (np.asarray(vertices, np.float64) - cell_origin) * scale


def fragment_draco_settings(vertex_quantization_bits: int = 16) -> dict:
  """Draco encode settings for a stored-lattice fragment: one more bit
  than the lattice and range 2**(bits+1)-1 makes the draco bin size
  exactly 1 lattice unit, so lattice integers 0..2**bits round-trip
  bit-exactly and adjacent fragments stitch on shared wall points (with
  the lattice transform applied first, the general quantization solver
  reduces to this closed form)."""
  bits = vertex_quantization_bits + 1
  if bits > 30:
    raise ValueError(f"vertex_quantization_bits too large: {bits - 1}")
  return {
    "quantization_bits": bits,
    "quantization_origin": (0.0, 0.0, 0.0),
    "quantization_range": float((1 << bits) - 1),
  }


def _zorder(positions: np.ndarray) -> np.ndarray:
  """Sort order of (n, 3) grid positions by compressed morton code."""
  if len(positions) == 0:
    return np.zeros(0, dtype=np.int64)
  gs = positions.max(axis=0) + 1
  codes = [int(compressed_morton_code(p, gs)) for p in positions]
  return np.argsort(np.asarray(codes), kind="stable")


def clip_polygons(
  verts: np.ndarray, counts: np.ndarray, axis: int, sign: float, bound: float
) -> Tuple[np.ndarray, np.ndarray]:
  """Sutherland-Hodgman clip of padded polygons against one axis plane.

  verts (P, K, 3) float64 with per-polygon vertex counts; keeps the
  half-space ``sign * (x[axis] - bound) <= 0``. Vectorized over polygons —
  the per-edge loop runs K (≤ 9) times regardless of P.
  """
  P, K, _ = verts.shape
  out = np.zeros((P, K + 1, 3), dtype=np.float64)
  outc = np.zeros(P, dtype=np.int64)
  d = sign * (verts[:, :, axis] - bound)  # signed distance, (P, K)
  inside = d <= 1e-9
  rows = np.arange(P)
  for k in range(K):
    valid = k < counts
    j = np.where(k + 1 < counts, k + 1, 0)
    vi, vj = verts[rows, k], verts[rows, j]
    di, dj = d[rows, k], d[rows, j]
    ini, inj = inside[rows, k], inside[rows, j]
    # emit current vertex if inside
    emit = valid & ini
    out[rows[emit], outc[emit]] = vi[emit]
    outc[emit] += 1
    # emit intersection if the edge crosses the plane; clamp t — the
    # inside tolerance admits points marginally past the plane, and an
    # unclamped near-parallel edge would extrapolate a spike far outside
    cross = valid & (ini != inj)
    if cross.any():
      t = np.clip(di[cross] / (di[cross] - dj[cross]), 0.0, 1.0)
      pt = vi[cross] + t[:, None] * (vj[cross] - vi[cross])
      pt[:, axis] = bound  # exact landing on the wall (lattice-stitchable)
      out[rows[cross], outc[cross]] = pt
      outc[cross] += 1
  return out, outc


def _triangulate_fans(verts: np.ndarray, counts: np.ndarray) -> np.ndarray:
  """Fan-triangulate padded convex polygons → (T, 3, 3) triangles."""
  tris = []
  for c in range(3, int(counts.max()) + 1 if len(counts) else 3):
    sel = counts >= c
    if not sel.any():
      continue
    v = verts[sel]
    tris.append(np.stack([v[:, 0], v[:, c - 2], v[:, c - 1]], axis=1))
  if not tris:
    return np.zeros((0, 3, 3), dtype=np.float64)
  return np.concatenate(tris, axis=0)


def clip_triangles_to_box(
  tri: np.ndarray, lo: np.ndarray, hi: np.ndarray
) -> np.ndarray:
  """Clip triangles (T, 3, 3) to an axis box; returns retriangulated
  (T', 3, 3), as zmesh.chunk_mesh does: fragment geometry ends exactly at cell walls so
  per-cell quantization never clamps, and adjacent fragments stitch."""
  if len(tri) == 0:
    return np.zeros((0, 3, 3), dtype=np.float64)
  K = 3
  verts = np.zeros((len(tri), K, 3), dtype=np.float64)
  verts[:, :3] = tri
  counts = np.full(len(tri), 3, dtype=np.int64)
  for axis in range(3):
    for sign, bound in ((-1.0, float(lo[axis])), (1.0, float(hi[axis]))):
      verts, counts = clip_polygons(verts, counts, axis, sign, bound)
      keep = counts >= 3
      verts, counts = verts[keep], counts[keep]
      if len(verts) == 0:
        return np.zeros((0, 3, 3), dtype=np.float64)
  return _triangulate_fans(verts, counts)


def octree_fragments(
  mesh: Mesh, chunk_size: np.ndarray, grid_origin: np.ndarray
) -> Dict[Tuple[int, int, int], Mesh]:
  """Split a mesh into octree cells, retriangulating triangles at cell
  walls (as zmesh.chunk_mesh does). Triangles fully inside a cell pass through
  untouched; spanning triangles are clipped into every cell they touch so
  fragment geometry lies exactly within its cell — required for the
  per-cell draco quantization lattice."""
  if len(mesh.faces) == 0:
    return {}
  chunk_size = np.asarray(chunk_size, dtype=np.float64)
  grid_origin = np.asarray(grid_origin, dtype=np.float64)
  tri = mesh.vertices[mesh.faces.astype(np.int64)].astype(np.float64)
  eps = 1e-9
  clo = np.floor((tri.min(axis=1) - grid_origin) / chunk_size - eps)
  chi = np.floor((tri.max(axis=1) - grid_origin) / chunk_size + eps)
  clo = np.maximum(clo.astype(np.int64), 0)
  chi = np.maximum(chi.astype(np.int64), clo)
  # a triangle flat along an axis and sitting exactly on a cell wall would
  # satisfy the inclusive clip of BOTH adjacent cells and be emitted twice;
  # pin such axes to the centroid's cell (the old centroid convention)
  flat = (tri.max(axis=1) - tri.min(axis=1)) <= eps * np.maximum(chunk_size, 1)
  if flat.any():
    cen = np.floor(
      (tri.mean(axis=1) - grid_origin) / chunk_size
    ).astype(np.int64)
    cen = np.maximum(cen, 0)
    clo = np.where(flat, cen, clo)
    chi = np.where(flat, cen, chi)

  spanning = (chi != clo).any(axis=1)
  out_tris: Dict[Tuple[int, int, int], List[np.ndarray]] = {}

  # bulk path: triangles entirely inside one cell
  interior = ~spanning
  if interior.any():
    keys, inverse = np.unique(clo[interior], axis=0, return_inverse=True)
    idx = np.flatnonzero(interior)
    for i, key in enumerate(keys):
      out_tris.setdefault(tuple(int(v) for v in key), []).append(
        tri[idx[inverse == i]]
      )

  # clip path: the minority of triangles that cross cell walls
  if spanning.any():
    span_cells: Dict[Tuple[int, int, int], List[int]] = {}
    for t in np.flatnonzero(spanning):
      for cx in range(clo[t, 0], chi[t, 0] + 1):
        for cy in range(clo[t, 1], chi[t, 1] + 1):
          for cz in range(clo[t, 2], chi[t, 2] + 1):
            span_cells.setdefault((cx, cy, cz), []).append(t)
    for key, tids in span_cells.items():
      lo = grid_origin + np.asarray(key, np.float64) * chunk_size
      hi = lo + chunk_size
      clipped = clip_triangles_to_box(tri[tids], lo, hi)
      if len(clipped):
        # drop zero-area slivers (e.g. an edge lying in this cell's wall
        # whose triangle body is in the neighbor): they render nothing
        # and would duplicate wall geometry across cells
        n = np.cross(
          clipped[:, 1] - clipped[:, 0], clipped[:, 2] - clipped[:, 0]
        )
        area2 = np.linalg.norm(n, axis=1)
        min_area2 = (1e-6 * float(chunk_size.max())) ** 2
        clipped = clipped[area2 > min_area2]
      if len(clipped):
        out_tris.setdefault(key, []).append(clipped)

  out: Dict[Tuple[int, int, int], Mesh] = {}
  for key, pieces in out_tris.items():
    tris = np.concatenate(pieces, axis=0)
    nverts = 3 * len(tris)
    sub = Mesh(
      tris.reshape(-1, 3).astype(np.float32),
      np.arange(nverts, dtype=np.uint32).reshape(-1, 3),
    ).consolidate()
    if len(sub.faces):
      out[key] = sub
  return out


def generate_lods(mesh: Mesh, num_lods: int, reduction: float = 4.0) -> List[Mesh]:
  """LOD pyramid: lod 0 is the full mesh; each level reduces ~4x through
  ``simplify`` with no error bound."""
  lods = [mesh]
  for _ in range(1, num_lods):
    prev = lods[-1]
    if len(prev.faces) <= 16:
      lods.append(prev.clone())
      continue
    lods.append(simplify(prev, reduction_factor=reduction, max_error=None))
  return lods


def process_mesh(
  mesh: Mesh,
  num_lods: int = 2,
  chunk_size: Optional[Sequence[float]] = None,
  encoding: str = "draco",
  quantization_bits: int = 16,
  min_chunk_size: Optional[Sequence[float]] = None,
) -> Tuple[bytes, bytes]:
  """One label's mesh → (manifest bytes, concatenated fragment bytes).

  Neuroglancer multilod manifest layout (little endian):
    chunk_shape float32[3] | grid_origin float32[3] | num_lods uint32 |
    lod_scales float32[num_lods] | vertex_offsets float32[num_lods][3] |
    num_fragments_per_lod uint32[num_lods] |
    per lod: fragment_positions uint32[n][3], fragment_offsets uint32[n]
  Fragment data is concatenated lod 0 … lod n-1, z-order within each lod,
  in exactly the order fragment_offsets describes.
  """
  mesh = mesh.consolidate()
  if len(mesh.vertices) == 0:
    raise ValueError("empty mesh")
  mn = mesh.vertices.min(axis=0)
  mx = mesh.vertices.max(axis=0)
  if min_chunk_size is not None:
    # cap the LOD count so the finest fragment cell is at least
    # min_chunk_size (same units as the vertices)
    ext = np.maximum(np.asarray(mx - mn, dtype=np.float64), 1e-9)
    ratio = ext / np.maximum(np.asarray(min_chunk_size, np.float64), 1e-9)
    cap = 1 + max(int(np.floor(np.min(np.log2(np.maximum(ratio, 1.0))))), 0)
    num_lods = max(1, min(num_lods, cap))
  if chunk_size is None:
    # one chunk at the coarsest lod
    chunk_size = (mx - mn) / (2 ** (num_lods - 1)) + 1e-3
  chunk_size = np.asarray(chunk_size, dtype=np.float32)
  grid_origin = mn.astype(np.float32)

  lods = generate_lods(mesh, num_lods)

  frag_payloads: List[bytes] = []
  lod_positions: List[np.ndarray] = []
  lod_sizes: List[np.ndarray] = []
  for lod, lod_mesh in enumerate(lods):
    cell = chunk_size * (2**lod)
    frags = octree_fragments(lod_mesh, cell, grid_origin)
    positions = np.asarray(sorted(frags.keys()), dtype=np.int64).reshape(-1, 3)
    order = _zorder(positions)
    positions = positions[order]
    sizes = []
    for pos in positions:
      frag = frags[tuple(int(v) for v in pos)]
      kw = {}
      if encoding == "draco":
        # per-axis stored-lattice transform + 1-lattice-unit draco bins:
        # the renderer maps stored integers onto the fragment cell, so
        # anisotropic cells need per-axis normalization, not a scalar
        # range
        frag = Mesh(
          to_stored_lattice(
            frag.vertices, grid_origin + pos * cell, cell, quantization_bits
          ).astype(np.float32),
          frag.faces,
        )
        kw = fragment_draco_settings(quantization_bits)
      payload = encode_mesh(frag, encoding, **kw)
      frag_payloads.append(payload)
      sizes.append(len(payload))
    lod_positions.append(positions.astype(np.uint32))
    lod_sizes.append(np.asarray(sizes, dtype=np.uint32))

  manifest = [
    chunk_size.astype("<f4").tobytes(),
    grid_origin.astype("<f4").tobytes(),
    struct.pack("<I", num_lods),
    np.asarray([2.0**lod for lod in range(num_lods)], "<f4").tobytes(),
    np.zeros((num_lods, 3), "<f4").tobytes(),  # vertex_offsets
    np.asarray([len(p) for p in lod_positions], "<u4").tobytes(),
  ]
  for positions, sizes in zip(lod_positions, lod_sizes):
    manifest.append(positions.astype("<u4").tobytes())
    manifest.append(sizes.astype("<u4").tobytes())

  return b"".join(manifest), b"".join(frag_payloads)


def multires_info(
  vertex_quantization_bits: int = 16,
  transform: Optional[Sequence[float]] = None,
  sharding: Optional[dict] = None,
  mip: int = 0,
) -> dict:
  """The multires mesh dir's info file."""
  info = {
    "@type": "neuroglancer_multilod_draco",
    "vertex_quantization_bits": int(vertex_quantization_bits),
    "transform": list(transform) if transform is not None
    else [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
    "lod_scale_multiplier": 1,
    "mip": int(mip),
  }
  if sharding is not None:
    info["sharding"] = sharding
  return info
