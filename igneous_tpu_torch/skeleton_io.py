"""Skeleton container, Precomputed skeleton codec and postprocessing.

The port's own copy of ``Skeleton``, ``DEFAULT_ATTRIBUTES`` and
``postprocess``, ``to_swc`` and ``from_swc`` from
``igneous_tpu/skeleton_io.py`` (cloud-volume's Skeleton type, kimimaro's
postprocess and the SWC text of ``skeleton convert``), so that both
packages write the same bytes.

Precomputed skeleton fragment format (Neuroglancer spec):
  uint32le num_vertices, uint32le num_edges,
  float32le positions[3 * V] (x, y, z physical units),
  uint32le edges[2 * E],
  then each vertex attribute (info order): radius float32[V],
  vertex_types uint8[V].
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_ATTRIBUTES = [
  {"id": "radius", "data_type": "float32", "num_components": 1},
  {"id": "vertex_types", "data_type": "uint8", "num_components": 1},
]

_DTYPES = {"float32": "<f4", "uint8": "u1", "uint16": "<u2", "uint32": "<u4",
           "int8": "i1", "int16": "<i2", "int32": "<i4", "float64": "<f8"}


class Skeleton:
  def __init__(
    self,
    vertices=None,
    edges=None,
    radii=None,
    vertex_types=None,
    extra_attributes: Optional[Dict[str, np.ndarray]] = None,
  ):
    self.vertices = (
      np.zeros((0, 3), np.float32)
      if vertices is None
      else np.asarray(vertices, np.float32).reshape(-1, 3)
    )
    n = len(self.vertices)
    self.edges = (
      np.zeros((0, 2), np.uint32)
      if edges is None
      else np.asarray(edges, np.uint32).reshape(-1, 2)
    )
    self.radii = (
      np.full(n, -1, np.float32) if radii is None
      else np.asarray(radii, np.float32)
    )
    self.vertex_types = (
      np.zeros(n, np.uint8) if vertex_types is None
      else np.asarray(vertex_types, np.uint8)
    )
    self.extra_attributes = dict(extra_attributes or {})

  def __len__(self):
    return len(self.vertices)

  @property
  def empty(self) -> bool:
    return len(self.vertices) == 0

  def clone(self) -> "Skeleton":
    return Skeleton(
      self.vertices.copy(), self.edges.copy(), self.radii.copy(),
      self.vertex_types.copy(),
      {k: v.copy() for k, v in self.extra_attributes.items()},
    )

  # -- merge / cleanup ------------------------------------------------------

  @classmethod
  def simple_merge(cls, skeletons: Sequence["Skeleton"]) -> "Skeleton":
    skeletons = [s for s in skeletons if not s.empty]
    if not skeletons:
      return cls()
    voff = 0
    verts, edges, radii, vtypes = [], [], [], []
    extras: Dict[str, List[np.ndarray]] = {}
    for s in skeletons:
      verts.append(s.vertices)
      edges.append(s.edges + np.uint32(voff))
      radii.append(s.radii)
      vtypes.append(s.vertex_types)
      for k, v in s.extra_attributes.items():
        extras.setdefault(k, []).append(v)
      voff += len(s.vertices)
    return cls(
      np.concatenate(verts), np.concatenate(edges),
      np.concatenate(radii), np.concatenate(vtypes),
      {k: np.concatenate(v) for k, v in extras.items()},
    )

  def consolidate(self) -> "Skeleton":
    """Weld identical vertex positions, dedupe edges, drop self-loops."""
    if self.empty:
      return self.clone()
    uniq, inverse = np.unique(self.vertices, axis=0, return_inverse=True)
    edges = inverse[self.edges.astype(np.int64)].astype(np.uint32)
    edges = np.sort(edges, axis=1)
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.unique(edges, axis=0) if len(edges) else edges
    # carry attributes from the first occurrence of each welded vertex
    first = np.full(len(uniq), len(self.vertices), dtype=np.int64)
    order = np.arange(len(self.vertices))
    np.minimum.at(first, inverse, order)
    out = Skeleton(
      uniq, edges, self.radii[first], self.vertex_types[first],
      {k: v[first] for k, v in self.extra_attributes.items()},
    )
    return out

  def components_by_vertex(self) -> np.ndarray:
    """Connected component id per vertex (union-find over edges)."""
    n = len(self.vertices)
    parent = np.arange(n, dtype=np.int64)

    def find(x):
      root = x
      while parent[root] != root:
        root = parent[root]
      while parent[x] != root:
        parent[x], x = root, parent[x]
      return root

    for a, b in self.edges.astype(np.int64):
      ra, rb = find(a), find(b)
      if ra != rb:
        parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(n)], dtype=np.int64)

  def cable_length(self) -> float:
    if len(self.edges) == 0:
      return 0.0
    d = self.vertices[self.edges[:, 0].astype(np.int64)] - \
        self.vertices[self.edges[:, 1].astype(np.int64)]
    return float(np.linalg.norm(d, axis=1).sum())

  def crop(self, bbox) -> "Skeleton":
    """Keep vertices inside bbox (physical units) and edges between them."""
    keep = np.all(
      (self.vertices >= np.asarray(bbox.minpt, np.float32))
      & (self.vertices < np.asarray(bbox.maxpt, np.float32)),
      axis=1,
    )
    return self._select_vertices(keep)

  def _select_vertices(self, keep: np.ndarray) -> "Skeleton":
    remap = np.cumsum(keep) - 1
    edges = self.edges.astype(np.int64)
    emask = keep[edges[:, 0]] & keep[edges[:, 1]]
    return Skeleton(
      self.vertices[keep],
      remap[edges[emask]].astype(np.uint32),
      self.radii[keep],
      self.vertex_types[keep],
      {k: v[keep] for k, v in self.extra_attributes.items()},
    )

  # -- codec ----------------------------------------------------------------

  def to_precomputed(self) -> bytes:
    out = [
      struct.pack("<II", len(self.vertices), len(self.edges)),
      self.vertices.astype("<f4").tobytes(),
      self.edges.astype("<u4").tobytes(),
      self.radii.astype("<f4").tobytes(),
      self.vertex_types.astype("u1").tobytes(),
    ]
    for name in sorted(self.extra_attributes):
      arr = np.ascontiguousarray(self.extra_attributes[name])
      # pin the wire dtype to what the info declares (extras are float32
      # single-component by convention here): an accidental float64 array
      # would silently shift every byte after it
      if arr.dtype.kind == "f" and arr.dtype.itemsize != 4:
        arr = arr.astype("<f4")
      out.append(arr.tobytes())
    return b"".join(out)

  @classmethod
  def from_precomputed(
    cls, data: bytes, vertex_attributes: Optional[List[dict]] = None
  ) -> "Skeleton":
    attrs = vertex_attributes or DEFAULT_ATTRIBUTES
    nv, ne = struct.unpack_from("<II", data, 0)
    pos = 8
    vertices = np.frombuffer(data, "<f4", 3 * nv, pos).reshape(-1, 3)
    pos += 12 * nv
    edges = np.frombuffer(data, "<u4", 2 * ne, pos).reshape(-1, 2)
    pos += 8 * ne
    radii = None
    vertex_types = None
    extra = {}
    for att in attrs:
      dt = np.dtype(_DTYPES[att["data_type"]])
      count = nv * int(att.get("num_components", 1))
      arr = np.frombuffer(data, dt, count, pos)
      pos += dt.itemsize * count
      if att["id"] == "radius":
        radii = arr.astype(np.float32)
      elif att["id"] == "vertex_types":
        vertex_types = arr.astype(np.uint8)
      else:
        extra[att["id"]] = arr.copy()
    return cls(vertices.copy(), edges.copy(), radii, vertex_types, extra)


def to_swc(skel: Skeleton, label: Optional[int] = None) -> str:
  """SWC text export (`igneous skeleton convert` capability).

  SWC rows: id type x y z radius parent; forests emit one root (-1
  parent) per connected component."""
  lines = []
  if label is not None:
    lines.append(f"# label {label}")
  n = len(skel.vertices)
  adj: Dict[int, List[int]] = {}
  for a, b in skel.edges.astype(np.int64):
    adj.setdefault(int(a), []).append(int(b))
    adj.setdefault(int(b), []).append(int(a))

  parent = np.full(n, -2, dtype=np.int64)  # -2 = unvisited
  order: List[int] = []
  for start in range(n):
    if parent[start] != -2:
      continue
    parent[start] = -1
    stack = [start]
    while stack:
      cur = stack.pop()
      order.append(cur)
      for nxt in adj.get(cur, []):
        if parent[nxt] == -2:
          parent[nxt] = cur
          stack.append(nxt)

  swc_id = np.zeros(n, dtype=np.int64)
  for i, v in enumerate(order, start=1):
    swc_id[v] = i
  for v in order:
    x, y, z = skel.vertices[v]
    r = float(skel.radii[v]) if skel.radii[v] > 0 else 1.0
    p = -1 if parent[v] < 0 else int(swc_id[parent[v]])
    t = int(skel.vertex_types[v])
    lines.append(
      f"{int(swc_id[v])} {t} {x:.1f} {y:.1f} {z:.1f} {r:.3f} {p}"
    )
  return "\n".join(lines) + "\n"


def from_swc(text: str) -> Skeleton:
  verts, radii, types = [], [], []
  edges = []
  id_map: Dict[int, int] = {}
  rows = []
  for line in text.splitlines():
    line = line.strip()
    if not line or line.startswith("#"):
      continue
    parts = line.split()
    rows.append((
      int(parts[0]), int(parts[1]),
      float(parts[2]), float(parts[3]), float(parts[4]),
      float(parts[5]), int(parts[6]),
    ))
  for sid, t, x, y, z, r, _p in rows:
    id_map[sid] = len(verts)
    verts.append((x, y, z))
    radii.append(r)
    types.append(t)
  for sid, _t, _x, _y, _z, _r, p in rows:
    if p >= 0:
      edges.append((id_map[p], id_map[sid]))
  return Skeleton(verts, edges, radii=radii, vertex_types=types)


def postprocess(
  skel: Skeleton,
  dust_threshold: float = 1000.0,
  tick_threshold: float = 900.0,
) -> Skeleton:
  """kimimaro.postprocess parity: weld, drop dust components by cable
  length (physical units), prune short terminal twigs ("ticks")."""
  skel = skel.consolidate()
  if skel.empty:
    return skel

  # dust: remove connected components with cable length < dust_threshold
  comp = skel.components_by_vertex()
  edges = skel.edges.astype(np.int64)
  seg_len = np.linalg.norm(
    skel.vertices[edges[:, 0]] - skel.vertices[edges[:, 1]], axis=1
  )
  comp_len: Dict[int, float] = {}
  for c, l in zip(comp[edges[:, 0]], seg_len):
    comp_len[c] = comp_len.get(c, 0.0) + float(l)
  keep_comp = {c for c, l in comp_len.items() if l >= dust_threshold}
  keep = np.array([c in keep_comp for c in comp], dtype=bool)
  skel = skel._select_vertices(keep)
  if skel.empty:
    return skel

  # ticks: repeatedly prune terminal branches shorter than tick_threshold
  # (never removing the entire component)
  changed = True
  while changed:
    changed = False
    edges = skel.edges.astype(np.int64)
    n = len(skel.vertices)
    deg = np.bincount(edges.reshape(-1), minlength=n)
    adj: Dict[int, List[int]] = {}
    for idx, (a, b) in enumerate(edges):
      adj.setdefault(int(a), []).append(idx)
      adj.setdefault(int(b), []).append(idx)
    seg_len = np.linalg.norm(
      skel.vertices[edges[:, 0]] - skel.vertices[edges[:, 1]], axis=1
    )
    remove_vertices = set()
    for leaf in np.flatnonzero(deg == 1):
      # walk from the leaf toward the next branch point (deg >= 3)
      path = [int(leaf)]
      length = 0.0
      prev = -1
      cur = int(leaf)
      ended_at_branch = False
      while length < tick_threshold:
        nxt = None
        for eidx in adj.get(cur, []):
          a, b = int(edges[eidx, 0]), int(edges[eidx, 1])
          other = b if a == cur else a
          if other != prev:
            nxt = (other, eidx)
            break
        if nxt is None:
          break  # dead end: the twig is the whole path (bare component)
        other, eidx = nxt
        length += float(seg_len[eidx])
        if deg[other] >= 3:
          ended_at_branch = True
          break
        path.append(other)
        prev, cur = cur, other
      # only prune twigs hanging off a branch point; a bare path with no
      # branch point is the component itself and stays
      if ended_at_branch and length < tick_threshold:
        remove_vertices.update(path)
    if remove_vertices:
      keep = np.ones(len(skel.vertices), dtype=bool)
      keep[list(remove_vertices)] = False
      pruned = skel._select_vertices(keep)
      if not pruned.empty:
        skel = pruned
        changed = True
  return skel
