"""Cross-sectional area at skeleton vertices, on the host.

The port's own copy of ``igneous_tpu/ops/cross_section.py`` (kimimaro's
``cross_sectional_area``, xs3d semantics): for vertex v with unit physical
tangent t, the slice is the plane through v with normal t. Every voxel
cube the plane crosses and that is flood-connected to v within the crossed
set contributes the exact area of (plane ∩ cube), a convex polygon; the
sum is the planar section area of the voxelized solid. The per-cube sum
is ``csrc/xsection.cpp``, the same source the JAX package builds, with the
same g++ flags (``ops._build.GXX_FLAGS``), so the areas are the same bits.
Its numpy twin ``_plane_cube_areas_py`` (on the port's
``mesh_multires.clip_polygons``) is the plain version the tests hold the
library against. Host work, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from ..skeleton_io import Skeleton
from . import _build


def xsection_lib() -> ctypes.CDLL:
  """``csrc/xsection.cpp`` (a byte copy of the JAX package's
  ``native/csrc/xsection.cpp``), built with g++ at first use and the JAX
  package's flags, so both packages sum the same areas in the same
  rounding; a failed build raises."""
  lib = _build.load("xsection")
  if not getattr(lib, "_configured", False):
    lib.xs_plane_cubes_area.restype = ctypes.c_double
    lib.xs_plane_cubes_area.argtypes = [
      ctypes.c_void_p, ctypes.c_longlong,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib._configured = True
  return lib


def vertex_tangents(skel: Skeleton, smoothing_window: int = 1) -> np.ndarray:
  """Unit tangent per vertex: mean direction of incident edges.

  ``smoothing_window`` > 1 averages each vertex's tangent with the
  sign-aligned tangents of vertices within ceil((w-1)/2) graph hops —
  the reference's kimimaro ``cross_sectional_area(smoothing_window=...)``
  knob, which steadies slice normals on jagged centerlines
  (reference tasks/skeleton.py:449-457)."""
  n = len(skel.vertices)
  tangents = np.zeros((n, 3), np.float32)
  edges = skel.edges.astype(np.int64)
  for a, b in edges:
    d = skel.vertices[b] - skel.vertices[a]
    norm = np.linalg.norm(d)
    if norm == 0:
      continue
    d = d / norm
    # orient consistently (sign-insensitive accumulation)
    for idx in (a, b):
      ref = tangents[idx]
      if np.dot(ref, d) < 0:
        tangents[idx] -= d
      else:
        tangents[idx] += d
  norms = np.linalg.norm(tangents, axis=1, keepdims=True)
  norms[norms == 0] = 1.0
  tangents = tangents / norms

  w = int(smoothing_window)
  if w > 1 and len(edges):
    hops = (w - 1 + 1) // 2  # ceil((w-1)/2)
    adj = [[] for _ in range(n)]
    for a, b in edges:
      adj[a].append(int(b))
      adj[b].append(int(a))
    smoothed = np.empty_like(tangents)
    for i in range(n):
      seen = {i}
      frontier = [i]
      for _ in range(hops):
        nxt = []
        for u in frontier:
          for v in adj[u]:
            if v not in seen:
              seen.add(v)
              nxt.append(v)
        frontier = nxt
      acc = np.zeros(3, np.float32)
      ref = tangents[i]
      for u in seen:
        t = tangents[u]
        acc += -t if np.dot(ref, t) < 0 else t
      norm = np.linalg.norm(acc)
      smoothed[i] = acc / norm if norm > 0 else ref
    tangents = smoothed
  return tangents


def _plane_basis(t: np.ndarray):
  """Two unit vectors spanning the plane with unit normal t."""
  e = np.zeros(3)
  e[int(np.argmin(np.abs(t)))] = 1.0
  u = np.cross(t, e)
  u /= np.linalg.norm(u)
  return u, np.cross(t, u)


def _plane_cube_areas(
  vox_idx: np.ndarray, v_phys: np.ndarray, t: np.ndarray, anis: np.ndarray
) -> float:
  """Exact Σ area(plane ∩ cube) over voxel cubes at integer indices
  vox_idx (K, 3); plane through v_phys with unit normal t. Convention:
  index i is the CUBE CENTER, i.e. cube k spans
  [(vox_idx-1/2)*anis, (vox_idx+1/2)*anis). Computed by
  ``csrc/xsection.cpp`` (the same algorithm with the same tolerances,
  scalar C++); ``_plane_cube_areas_py`` is its numpy twin."""
  if len(vox_idx) == 0:
    return 0.0
  vi = np.ascontiguousarray(vox_idx, dtype=np.int64)
  v = np.ascontiguousarray(v_phys, dtype=np.float64)
  tn = np.ascontiguousarray(t, dtype=np.float64)
  an = np.ascontiguousarray(anis, dtype=np.float64)
  return float(xsection_lib().xs_plane_cubes_area(
    vi.ctypes.data_as(ctypes.c_void_p), len(vi),
    v.ctypes.data_as(ctypes.c_void_p),
    tn.ctypes.data_as(ctypes.c_void_p),
    an.ctypes.data_as(ctypes.c_void_p),
  ))


def _plane_cube_areas_py(
  vox_idx: np.ndarray, v_phys: np.ndarray, t: np.ndarray, anis: np.ndarray
) -> float:
  """Numpy twin of ``csrc/xsection.cpp``: the plain version the tests
  hold the library against (never a fallback)."""
  from ..mesh_multires import clip_polygons

  if len(vox_idx) == 0:
    return 0.0
  centers = vox_idx.astype(np.float64) * anis
  lo_phys = centers - anis / 2.0
  d_c = (centers - v_phys) @ t
  # patch center: cube center projected onto the plane, cube-local coords
  p_rel = (centers - d_c[:, None] * t) - lo_phys
  s = float(np.linalg.norm(anis))  # covers any cube cross-section
  u, w = _plane_basis(t)
  quad = np.stack([
    p_rel + s * (u + w), p_rel + s * (u - w),
    p_rel + s * (-u - w), p_rel + s * (-u + w),
  ], axis=1)  # (K, 4, 3), ordered around the patch
  counts = np.full(len(quad), 4, dtype=np.int64)
  verts = quad
  for axis in range(3):
    for sign, bound in ((-1.0, 0.0), (1.0, float(anis[axis]))):
      verts, counts = clip_polygons(verts, counts, axis, sign, bound)
      keep = counts >= 3
      verts, counts = verts[keep], counts[keep]
      if len(verts) == 0:
        return 0.0
  # 3D shoelace per polygon: 0.5 * |sum_i (v_i - v_0) x (v_{i+1} - v_0)|
  total = 0.0
  rel = verts - verts[:, :1]
  acc = np.zeros((len(verts), 3))
  for i in range(1, verts.shape[1] - 1):
    valid = counts > i + 1
    if not valid.any():
      break
    acc[valid] += np.cross(rel[valid, i], rel[valid, i + 1])
  total = 0.5 * np.linalg.norm(acc, axis=1).sum()
  return float(total)


def cross_sectional_area(
  mask: np.ndarray,
  skel: Skeleton,
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  offset: Sequence[float] = (0.0, 0.0, 0.0),
  window: int = 48,
  vertex_mask: Optional[np.ndarray] = None,
  smoothing_window: int = 1,
) -> np.ndarray:
  """Per-vertex slice areas (physical units²) of one label's mask.

  ``vertex_mask``: optional bool array — compute only these vertices
  (others stay -1); the contact-repair pass uses it to revisit just the
  flagged vertices against a context re-download.

  ``skel`` vertices are physical; ``mask`` is the (x,y,z) label mask whose
  voxel grid starts at ``offset`` (voxels). Returns float32 values:
    area > 0   clean slice;
    area < 0   |area| is a LOWER BOUND — the slice was clipped by the
               window or the cutout boundary (the reference's
               boundary-contact case, which its repair pass re-visits,
               tasks/skeleton.py:574-720);
    -1         vertex outside the mask.
  """
  anis = np.asarray(anisotropy, np.float32)
  tangents = vertex_tangents(skel, smoothing_window=smoothing_window)
  out = np.full(len(skel.vertices), -1.0, np.float32)
  shape = np.asarray(mask.shape, dtype=np.int64)
  w = int(window)

  for i, (v, t) in enumerate(zip(skel.vertices, tangents)):
    if vertex_mask is not None and not vertex_mask[i]:
      continue
    vv = v / anis - np.asarray(offset, np.float32)  # voxel coords
    vi = np.round(vv).astype(np.int64)
    if np.any(vi < 0) or np.any(vi >= shape):
      continue
    if not mask[tuple(vi)]:
      continue
    if t[0] == 0 and t[1] == 0 and t[2] == 0:
      continue
    lo = np.maximum(vi - w, 0)
    hi = np.minimum(vi + w + 1, shape)
    sub = mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]

    # signed distance of each subwindow voxel center from the plane,
    # built from per-axis aranges (never a materialized (2w+1)^3 grid —
    # at the repair window of 150 that would be ~GB-scale)
    frac = (vi.astype(np.float32) - vv) * anis  # sub-voxel shift, physical
    axes = [
      (np.arange(lo[a], hi[a], dtype=np.float32) - vi[a])
      * (anis[a] * t[a])
      for a in range(3)
    ]
    dist = (
      axes[0][:, None, None] + axes[1][None, :, None]
      + axes[2][None, None, :]
    ) + float(frac @ t)
    # a cube is crossed by the plane iff the center's distance is within
    # the cube's support radius along the normal. Half-open: a plane
    # lying EXACTLY on a shared face belongs to one neighbor only —
    # inclusive-both would double-count the full face polygon
    support = 0.5 * float(np.abs(anis * t).sum())
    crossed = sub & (dist > -support) & (dist <= support)
    seed = tuple(vi - lo)
    if not crossed[seed]:
      # the rounded vertex voxel can land on the open side of the
      # half-open test (vertex exactly on a face); step to the crossed
      # neighbor along the dominant tangent axis
      ax = int(np.argmax(np.abs(t)))
      for step_dir in (1, -1):
        alt = np.asarray(seed)
        alt[ax] += step_dir
        if np.all(alt >= 0) and np.all(alt < np.asarray(sub.shape)) and \
            crossed[tuple(alt)]:
          seed = tuple(alt)
          break
      else:
        continue
    # connectivity within the crossed set: other branches crossing the
    # plane must not count (xs3d's contiguous-section semantics)
    labeled, _ = ndimage.label(crossed, structure=np.ones((3, 3, 3), bool))
    comp_mask = labeled == labeled[seed]

    # exact area: clip the plane against every crossed cube, sum polygons
    local_idx = np.argwhere(comp_mask)  # crop-window voxel indices
    vox_idx = local_idx + lo  # crop-frame voxel indices
    area = _plane_cube_areas(
      vox_idx, vv.astype(np.float64) * anis, t.astype(np.float64), anis
    )

    # truncation: the section touches the window or cutout boundary, so
    # the true slice may continue beyond what we counted (window-clipped
    # and cutout-contact cases both surface as a border touch)
    clipped = any(
      comp_mask.take(0, axis=a).any() or comp_mask.take(-1, axis=a).any()
      for a in range(3)
    )
    out[i] = -area if clipped else area
  return out
