"""Isosurface extraction on the port's device: marching cubes (the mesh
forge's default) and marching tetrahedra.

The port's own copy of ``igneous_tpu/ops/mesh.py``. The case tables are
generated here by the same numpy code (the JAX module cannot be imported).
The per-voxel work runs as torch operations on the device, batched over
the masks of one power-of-two shape bucket:

* the count pass (``_mc_count_kernel``, ``_count_kernel``): each cell's
  8-corner case index and triangle count, accumulated in place in uint8;
* the marching-cubes emission (``_mc_emit_batch``): exactly one slot per
  triangle, cells ascending in flat (z, y, x) order and triangles in table
  order within a cell, so ``_weld`` numbers vertices and faces as the JAX
  package does; marching tetrahedra emits on the host (``_emit_host``).

Only the triangles come back to the host, where ``_weld`` and
``_cancel_coincident_pairs`` run in numpy as in the JAX package. Masks are
padded to their bucket by replicating their last plane (an edge clamp of
the indices); triangles of pad-ring cells are dropped before emission.
Every output is byte-identical to the JAX package's on the same masks.

Stage timers (``telemetry``): count (masks and count pass), emit, d2h and
weld.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from ..observability.device import execute_span, transfer_span

# cube corner i sits at offset (i&1, i>>1&1, i>>2&1)
CORNER_OFFSETS = np.array(
  [[(i >> d) & 1 for d in range(3)] for i in range(8)], dtype=np.float32
)
# 6-tet decomposition sharing the 0-7 diagonal
TETS = np.array(
  [
    (0, 1, 3, 7),
    (0, 3, 2, 7),
    (0, 2, 6, 7),
    (0, 6, 4, 7),
    (0, 4, 5, 7),
    (0, 5, 1, 7),
  ],
  dtype=np.int32,
)


def _build_tables():
  """NTRIS[tet, case] and EDGES[tet, case, tri, vtx, 2] (cube corner pairs).

  Triangles are oriented so normals point from inside (mask=1) to outside.
  """
  ntris = np.zeros((6, 16), dtype=np.int32)
  edges = np.zeros((6, 16, 2, 3, 2), dtype=np.int32)

  for t, tet in enumerate(TETS):
    pts = CORNER_OFFSETS[tet]  # (4, 3) canonical coords
    for case in range(16):
      inside = [j for j in range(4) if (case >> j) & 1]
      outside = [j for j in range(4) if not (case >> j) & 1]
      tris = []  # list of [(a_local, b_local) x3]
      if len(inside) == 1:
        v = inside[0]
        tris.append([(v, outside[0]), (v, outside[1]), (v, outside[2])])
      elif len(inside) == 3:
        v = outside[0]
        tris.append([(inside[0], v), (inside[1], v), (inside[2], v)])
      elif len(inside) == 2:
        i0, i1 = inside
        o0, o1 = outside
        # cut quad in cyclic order
        quad = [(i0, o0), (i1, o0), (i1, o1), (i0, o1)]
        tris.append([quad[0], quad[1], quad[2]])
        tris.append([quad[0], quad[2], quad[3]])

      if not tris:
        continue
      in_centroid = pts[inside].mean(axis=0) if inside else pts.mean(axis=0)
      for k, tri in enumerate(tris):
        mids = np.array([(pts[a] + pts[b]) / 2.0 for a, b in tri])
        n = np.cross(mids[1] - mids[0], mids[2] - mids[0])
        outward = mids.mean(axis=0) - in_centroid
        if np.dot(n, outward) < 0:
          tri = [tri[0], tri[2], tri[1]]
        for v, (a, b) in enumerate(tri):
          edges[t, case, k, v, 0] = tet[a]
          edges[t, case, k, v, 1] = tet[b]
      ntris[t, case] = len(tris)
  return ntris, edges


NTRIS_TABLE, EDGES_TABLE = _build_tables()


def _build_mc_tables():
  """Generate the 256-case MC tables programmatically.

  For each corner-insideness case, surface segments are produced per cube
  face (0, 1, or 2 segments from the face's 4 crossing pattern; ambiguous
  faces, diagonal inside corners, always SEPARATE the inside corners, a
  rule that depends only on the shared face so adjacent cells agree and
  the global surface is watertight), chained into closed loops through
  the crossing cube edges (each crossing edge borders exactly two faces),
  and fan-triangulated. Orientation: each loop's Newell normal is made to
  point away from the mean of the loop's inside corner endpoints.

  Returns (ntri[256], tris[256, MAXT, 3] edge ids padded with 0,
  edge_mid[12, 3] midpoint offsets).
  """
  # 12 cube edges as corner pairs (corner i at (i&1, i>>1&1, i>>2&1))
  edge_pairs = []
  for a in range(8):
    for d in range(3):
      if not (a >> d) & 1:
        edge_pairs.append((a, a | (1 << d)))
  edge_id = {p: i for i, p in enumerate(edge_pairs)}  # 12 edges
  edge_mid = np.array(
    [(CORNER_OFFSETS[a] + CORNER_OFFSETS[b]) / 2.0 for a, b in edge_pairs],
    dtype=np.float32,
  )

  # 6 faces: (axis, side) -> 4 corners in cyclic order around the face
  faces = []
  for d in range(3):
    u, v = (d + 1) % 3, (d + 2) % 3
    for s in (0, 1):
      cyc = []
      for bu, bv in ((0, 0), (1, 0), (1, 1), (0, 1)):
        cyc.append((s << d) | (bu << u) | (bv << v))
      faces.append(cyc)

  all_tris = []
  for case in range(256):
    inside = [(case >> i) & 1 for i in range(8)]
    segments = []  # pairs of edge ids
    for cyc in faces:
      cross = [
        k for k in range(4)
        if inside[cyc[k]] != inside[cyc[(k + 1) % 4]]
      ]  # indices into the face cycle: edge (cyc[k], cyc[k+1]) crosses
      def eid(k):
        a, b = cyc[k], cyc[(k + 1) % 4]
        return edge_id[(min(a, b), max(a, b))]
      if len(cross) == 2:
        segments.append((eid(cross[0]), eid(cross[1])))
      elif len(cross) == 4:
        # ambiguous: exactly two diagonal inside corners; cut each inside
        # corner off individually. corner cyc[k] sits between face edges
        # k-1 and k.
        for k in range(4):
          if inside[cyc[k]] and not inside[cyc[(k + 1) % 4]] \
             and not inside[cyc[(k - 1) % 4]]:
            segments.append((eid((k - 1) % 4), eid(k)))

    # chain segments into loops (each crossing edge appears in exactly 2
    # segments -> every vertex has degree 2)
    tris_case = []
    if segments:
      adj = {}
      for a, b in segments:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
      unvisited = set(adj)
      loops = []
      while unvisited:
        start = min(unvisited)
        loop = [start]
        unvisited.discard(start)
        prev, cur = None, start
        while True:
          nxt = [x for x in adj[cur] if x != prev]
          # a double edge (two segments between the same pair) closes a
          # 2-loop; guard by preferring unvisited continuation
          nxt = nxt[0] if nxt else adj[cur][0]
          if nxt == start:
            break
          loop.append(nxt)
          unvisited.discard(nxt)
          prev, cur = cur, nxt
        loops.append(loop)

      for loop in loops:
        pts = edge_mid[loop]
        # Newell normal of the (possibly non-planar) loop
        n = np.zeros(3)
        for i in range(len(loop)):
          p0, p1 = pts[i], pts[(i + 1) % len(loop)]
          n += np.cross(p0, p1)
        # inside reference: mean of the loop's inside corner endpoints
        ref = np.zeros(3)
        cnt = 0
        for e in loop:
          a, b = edge_pairs[e]
          c = a if inside[a] else b
          ref += CORNER_OFFSETS[c]
          cnt += 1
        ref /= cnt
        flip = np.dot(n, pts.mean(axis=0) - ref) < 0
        for i in range(1, len(loop) - 1):
          t = (loop[0], loop[i], loop[i + 1])
          tris_case.append((t[0], t[2], t[1]) if flip else t)
    all_tris.append(tris_case)

  maxt = max(len(t) for t in all_tris)
  ntri = np.array([len(t) for t in all_tris], dtype=np.int32)
  tris = np.zeros((256, maxt, 3), dtype=np.int32)
  for case, tc in enumerate(all_tris):
    for k, t in enumerate(tc):
      tris[case, k] = t
  return ntri, tris, edge_mid


MC_NTRI, MC_TRIS, MC_EDGE_MID = _build_mc_tables()


@functools.lru_cache(maxsize=None)
def _table(name: str, device: str) -> torch.Tensor:
  """A case table as a tensor on ``device`` (uploaded once per device)."""
  arr = {
    "MC_NTRI": MC_NTRI.astype(np.uint8),
    "MC_TRIS": MC_TRIS.astype(np.int64),
    "MC_EDGE_MID": MC_EDGE_MID,
  }[name]
  return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# count passes


def _corner(mask: torch.Tensor, i: int) -> torch.Tensor:
  """The view of (..., z, y, x) ``mask`` at cube corner ``i`` of every cell."""
  cz, cy, cx = (s - 1 for s in mask.shape[-3:])
  ox, oy, oz = i & 1, (i >> 1) & 1, (i >> 2) & 1
  return mask[..., oz : oz + cz, oy : oy + cy, ox : ox + cx]


def _weighted_corners(mask: torch.Tensor, corners: Sequence[int]) -> torch.Tensor:
  """sum_j mask[corner j] << j over the cells, in uint8, accumulated in
  place (no temporary of the cell grid's size)."""
  out = _corner(mask, corners[0]).clone(memory_format=torch.contiguous_format)
  for j, c in enumerate(corners[1:], start=1):
    out.add_(_corner(mask, c), alpha=1 << j)
  return out


def _mc_count_kernel(mask: torch.Tensor):
  """mask (..., z, y, x) uint8 0/1 → (case (..., cz, cy, cx) uint8,
  ntri uint8, total int64 over each mask's cells).

  The 256-entry table gather goes one mask at a time, so its int32 index
  never spans a whole batch."""
  case = _weighted_corners(mask, range(8))
  ncells = int(np.prod(case.shape[-3:]))
  table = _table("MC_NTRI", str(case.device))
  ntri = torch.empty_like(case)
  flat_case, flat_ntri = case.view(-1, ncells), ntri.view(-1, ncells)
  for k in range(flat_case.shape[0]):
    torch.index_select(table, 0, flat_case[k].int(), out=flat_ntri[k])
  total = flat_ntri.sum(1, dtype=torch.int64).view(case.shape[:-3])
  return case, ntri, total


def _count_kernel(mask: torch.Tensor):
  """mask (..., z, y, x) uint8 0/1 → (6 per-tet case arrays, 6 per-tet
  triangle counts, total int64), all per cell in uint8.

  A tet case's triangle count is min(bits, 4 - bits) of its popcount."""
  cases, per_tet = [], []
  total = None
  for tet in TETS:
    c = _weighted_corners(mask, [int(t) for t in tet])
    b = (c & 1) + ((c >> 1) & 1) + ((c >> 2) & 1) + ((c >> 3) & 1)
    n = torch.minimum(b, 4 - b)
    cases.append(c)
    per_tet.append(n)
    s = n.flatten(-3).sum(-1, dtype=torch.int64)
    total = s if total is None else total + s
  return tuple(cases), tuple(per_tet), total


# ---------------------------------------------------------------------------
# emission


def _emit_slots(nt: torch.Tensor, total: int):
  """Flat per-cell triangle counts → (cell, k) int64 of every one of the
  ``total`` triangle slots: cells ascending, k ascending within a cell."""
  cells = torch.nonzero(nt).squeeze(1)
  reps = nt[cells].long()
  cell = torch.repeat_interleave(cells, reps, output_size=total)
  starts = torch.cumsum(reps, 0) - reps
  k = torch.arange(total, device=nt.device) - torch.repeat_interleave(
    starts, reps, output_size=total
  )
  return cell, k


def _mc_tris(case: torch.Tensor, cell: torch.Tensor, k: torch.Tensor):
  """(T, 3, 3) float32 vertex coords, (x, y, z) voxel units, of the
  triangles at flat ``cell`` indices of ``case`` (..., cz, cy, cx)."""
  cz, cy, cx = case.shape[-3:]
  dev = str(case.device)
  edges = _table("MC_TRIS", dev)[case.reshape(-1)[cell].long(), k]  # (T, 3)
  mid = _table("MC_EDGE_MID", dev)[edges]  # (T, 3, 3)
  local = cell % (cz * cy * cx)
  base = torch.stack(
    [local % cx, (local // cx) % cy, local // (cy * cx)], dim=-1
  ).to(torch.float32)
  return base[:, None, :] + mid


def _drop_pad_ring(ntri: torch.Tensor, real_cells) -> None:
  """Zero, in place, the counts of the (K, cz, cy, cx) ``ntri`` outside
  each member's real cells (rx, ry, rz)."""
  for k, (rx, ry, rz) in enumerate(real_cells):
    ntri[k, rz:] = 0
    ntri[k, :, ry:] = 0
    ntri[k, :, :, rx:] = 0


# nonzero and the flat cell indices stay below 2^31 elements per call
_EMIT_CELLS = 1 << 30


def _mc_emit_batch(case, ntri, real_cells) -> List[Optional[np.ndarray]]:
  """MC emission for K masks of one bucket: (K, cz, cy, cx) case and ntri
  (whose pad-ring counts this zeroes) → per mask its (n, 3, 3) float32
  triangles on the host, or None where it has none."""
  K = case.shape[0]
  out: List[Optional[np.ndarray]] = [None] * K
  ncells = int(np.prod(case.shape[1:]))
  per = max(1, _EMIT_CELLS // ncells)
  for k0 in range(0, K, per):
    c, n = case[k0 : k0 + per], ntri[k0 : k0 + per]
    with telemetry.stage("emit"):
      with execute_span("mesh.mc_emit", int(n.numel()), device=n.device):
        _drop_pad_ring(n, real_cells[k0 : k0 + per])
        counts = n.reshape(len(n), -1).sum(1, dtype=torch.int64).tolist()
        total = sum(counts)
        if total == 0:
          continue
        cell, kk = _emit_slots(n.reshape(-1), total)
        tris = _mc_tris(c, cell, kk)
        del cell, kk
      if tris.is_cuda:
        torch.cuda.synchronize(tris.device)
    with telemetry.stage("d2h"), transfer_span("d2h", tris.numel() * 4, tris.device):
      tris = tris.cpu().numpy()
    for j, part in enumerate(np.split(tris, np.cumsum(counts)[:-1])):
      if len(part):
        out[k0 + j] = part
  return out


def _emit_host(cases_np, per_np, shape, real_cells=None) -> np.ndarray:
  """Host-side triangle emission of marching tetrahedra: O(triangles)
  table lookups in numpy.

  ``real_cells``: (cx, cy, cz) cell counts of the un-padded mask; cells in
  the shape-bucketing pad ring are dropped. Returns (n, 3, 3) vertex
  coords in (x, y, z) voxel units.
  """
  sz, sy, sx = shape
  cz, cy, cx = sz - 1, sy - 1, sx - 1
  per = np.stack([p.reshape(-1) for p in per_np], axis=-1)  # (ncells, 6)

  # nonzero keeps allocation proportional to the surface, not the volume
  cell1, tet1 = np.nonzero(per >= 1)
  cell2, tet2 = np.nonzero(per >= 2)
  if real_cells is not None:
    # pad-ring filter on the O(surface) nonzero set only
    rx, ry, rz = real_cells

    def in_real(cell):
      return (
        (cell % cx < rx) & ((cell // cx) % cy < ry)
        & (cell // (cy * cx) < rz)
      )

    k1, k2 = in_real(cell1), in_real(cell2)
    cell1, tet1 = cell1[k1], tet1[k1]
    cell2, tet2 = cell2[k2], tet2[k2]
  cell = np.concatenate([cell1, cell2])
  tet = np.concatenate([tet1, tet2])
  tri = np.concatenate([
    np.zeros(len(cell1), dtype=np.int64),
    np.ones(len(cell2), dtype=np.int64),
  ])

  cases_flat = np.stack([c.reshape(-1) for c in cases_np], axis=-1)  # (ncells, 6)
  case = cases_flat[cell, tet]
  pair = EDGES_TABLE[tet, case, tri]  # (n, 3, 2)
  mid = (CORNER_OFFSETS[pair[..., 0]] + CORNER_OFFSETS[pair[..., 1]]) / 2.0

  base = np.stack(
    [cell % cx, (cell // cx) % cy, cell // (cy * cx)], axis=-1
  ).astype(np.float32)  # xyz
  return base[:, None, :] + mid


def _mt_emit_batch(cases, per_tet, totals, shape, real_cells):
  """Marching-tetrahedra emission for K masks: each live member's case
  and count arrays come to the host and ``_emit_host`` emits there."""
  out: List[Optional[np.ndarray]] = [None] * len(totals)
  for k, total in enumerate(totals):
    if total == 0:
      continue
    nbytes = sum(t[k].numel() * t.element_size() for t in (*cases, *per_tet))
    with telemetry.stage("d2h"), transfer_span("d2h", nbytes, cases[0].device):
      cases_np = [c[k].cpu().numpy() for c in cases]
      per_np = [p[k].cpu().numpy() for p in per_tet]
    with telemetry.stage("emit"):
      out[k] = _emit_host(cases_np, per_np, shape, real_cells=real_cells[k])
  return out


# ---------------------------------------------------------------------------
# buckets, masks and the weld


def _bucket_shape(orig) -> Tuple[int, int, int]:
  """Power-of-two shape bucket, so masks of different shapes batch into
  one count pass."""
  return tuple(max(8, 1 << int(np.ceil(np.log2(s)))) for s in orig)


def _pad_into(src: torch.Tensor, out: torch.Tensor) -> None:
  """Write (z, y, x) ``src`` into the larger (bz, by, bx) ``out``,
  replicating its last plane along each axis (indices clamped at the
  edge)."""
  if src.shape == out.shape:
    out.copy_(src)
    return
  idx = [
    torch.arange(b, device=src.device).clamp_(max=s - 1)
    for b, s in zip(out.shape, src.shape)
  ]
  tmp = src.index_select(0, idx[0]).index_select(1, idx[1])
  torch.index_select(tmp, 2, idx[2], out=out)


class ArrayMasks:
  """Binary (x, y, z) numpy masks, uploaded one at a time as a batch
  fills."""

  def __init__(self, masks):
    self.masks = list(masks)
    self.device = get_device()

  def __len__(self) -> int:
    return len(self.masks)

  def shape(self, i: int) -> Tuple[int, ...]:
    return tuple(self.masks[i].shape)

  def fill(self, i: int, out: torch.Tensor) -> None:
    m = np.ascontiguousarray(self.masks[i].astype(np.uint8).transpose(2, 1, 0))
    _pad_into(torch.from_numpy(m).to(out.device), out)


class LabelMasks:
  """The masks ``dense[box] == label`` of one renumbered cutout already on
  the device: ``dense`` is (z, y, x) int32, each box an (x, y, z) triple
  of slices. A mask is built on the device only when its batch fills."""

  def __init__(self, dense: torch.Tensor, boxes, ids):
    self.dense = dense
    self.boxes = list(boxes)
    self.ids = list(ids)
    self.device = dense.device

  def __len__(self) -> int:
    return len(self.boxes)

  def shape(self, i: int) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in self.boxes[i])

  def fill(self, i: int, out: torch.Tensor) -> None:
    sx, sy, sz = self.boxes[i]
    crop = self.dense[sz, sy, sx]
    _pad_into((crop == self.ids[i]).view(torch.uint8), out)


def _weld(tris, anisotropy, offset):
  """(n, 3, 3) half-lattice triangles → welded (verts, faces), physical."""
  from ..mesh_io import drop_degenerate_faces

  lattice = np.round(tris.reshape(-1, 3) * 2.0).astype(np.int64)
  # scalar-key unique: x occupies the top bits so the sort order (and
  # therefore the vertex numbering) is identical to lexicographic row
  # order. 21 bits per axis covers half-lattice coords to 2^21.
  key = (lattice[:, 0] << 42) | (lattice[:, 1] << 21) | lattice[:, 2]
  ukey, inverse = np.unique(key, return_inverse=True)
  uniq = np.empty((len(ukey), 3), dtype=np.int64)
  uniq[:, 0] = ukey >> 42
  uniq[:, 1] = (ukey >> 21) & 0x1FFFFF
  uniq[:, 2] = ukey & 0x1FFFFF
  vertices = uniq.astype(np.float32) / 2.0
  faces = inverse.reshape(-1, 3).astype(np.uint32)
  faces = drop_degenerate_faces(faces)
  faces = _cancel_coincident_pairs(faces)
  # prune vertices orphaned by the cancellation
  used = np.zeros(len(vertices), dtype=bool)
  used[faces.reshape(-1)] = True
  if not used.all():
    remap = np.cumsum(used) - 1
    vertices = vertices[used]
    faces = remap[faces.astype(np.int64)].astype(np.uint32)
  vertices = (vertices + np.asarray(offset, dtype=np.float32)) * np.asarray(
    anisotropy, dtype=np.float32
  )
  return vertices, faces


def _cancel_coincident_pairs(faces: np.ndarray) -> np.ndarray:
  """Drop pairs of coincident triangles (same vertex triple).

  Marching cubes' fan triangulation can place a diagonal in a cell face's
  plane; when the loop has further vertices on that same face, a whole fan
  triangle can lie IN the shared face and the neighboring cell emits the
  mirrored copy, a zero-volume fin. The pair cancels exactly: removing
  both lowers each boundary edge's face count by 2, so closedness (even
  counts) is preserved. An odd-multiplicity group (fin pair + a real
  surface triangle) keeps one member of the MAJORITY winding, so the
  survivor faces outward.
  """
  if len(faces) == 0:
    return faces
  tri = np.sort(faces, axis=1).astype(np.int64)
  if int(tri[:, 2].max()) < (1 << 21):
    # scalar-key grouping (fast path): collision-free while every vertex
    # index fits 21 bits...
    key = (tri[:, 0] << 42) | (tri[:, 1] << 21) | tri[:, 2]
    _, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
  else:
    # ...multi-million-vertex meshes fall back to exact row grouping
    _, inv, cnt = np.unique(tri, axis=0, return_inverse=True,
                            return_counts=True)
  if (cnt <= 1).all():
    return faces
  keep = cnt[inv] == 1
  # group duplicate rows by one argsort instead of rescanning per group
  dup_ids = np.flatnonzero(~keep)
  order = dup_ids[np.argsort(inv[dup_ids], kind="stable")]
  ginv = inv[order]
  starts = np.flatnonzero(np.concatenate([[True], ginv[1:] != ginv[:-1]]))
  ends = np.concatenate([starts[1:], [len(order)]])
  # winding parity: (a,b,c) is an even permutation of its sorted triple
  perm = np.argsort(faces[order], axis=1)
  even = (
    (perm == (0, 1, 2)).all(axis=1)
    | (perm == (1, 2, 0)).all(axis=1)
    | (perm == (2, 0, 1)).all(axis=1)
  )
  for s, e in zip(starts, ends):
    if (e - s) % 2 == 0:
      continue
    grp_even = even[s:e]
    maj = grp_even if grp_even.sum() * 2 > (e - s) else ~grp_even
    keep[order[s + int(np.flatnonzero(maj)[0])]] = True
  return faces[keep]


_EMPTY_MESH = (
  np.zeros((0, 3), dtype=np.float32), np.zeros((0, 3), dtype=np.uint32)
)


def _isosurface_batch(masks, anisotropy, offsets, batch_size, mesher):
  """Batched count and emission for both meshers.

  ``masks``: a list of binary (x, y, z) numpy masks, or a ``LabelMasks``.
  Masks are grouped by power-of-two shape bucket; each group of at most
  ``batch_size`` fills one (K, *bucket) uint8 tensor on the device and
  runs one count pass. Only the triangles come back; each mask's are
  welded on the host. Returns one (vertices, faces) per mask.
  """
  if not isinstance(masks, LabelMasks):
    masks = ArrayMasks(masks)
  if offsets is None:
    offsets = [(0.0, 0.0, 0.0)] * len(masks)
  out = [None] * len(masks)
  groups = {}
  for i in range(len(masks)):
    if len(masks.shape(i)) != 3:
      raise ValueError("masks must be 3d")
    groups.setdefault(_bucket_shape(masks.shape(i)), []).append(i)

  for (bx, by, bz), idxs in groups.items():
    for g0 in range(0, len(idxs), batch_size):
      gidx = idxs[g0 : g0 + batch_size]
      real = [tuple(s - 1 for s in masks.shape(i)) for i in gidx]
      with telemetry.stage("count"), execute_span(
        "mesh.mc_count" if mesher == "cubes" else "mesh.mt_count",
        len(gidx) * bz * by * bx, device=masks.device,
        signature=((len(gidx), bz, by, bx), mesher),
      ):
        batch = torch.empty(
          (len(gidx), bz, by, bx), dtype=torch.uint8, device=masks.device
        )
        for k, i in enumerate(gidx):
          masks.fill(i, batch[k])
        if mesher == "cubes":
          case, ntri, totals = _mc_count_kernel(batch)
        else:
          cases, per_tet, totals = _count_kernel(batch)
        del batch
        totals = totals.tolist()
      if mesher == "cubes":
        tris = _mc_emit_batch(case, ntri, real)
        del case, ntri
      else:
        tris = _mt_emit_batch(cases, per_tet, totals, (bz, by, bx), real)
        del cases, per_tet
      with telemetry.stage("weld"):
        for k, i in enumerate(gidx):
          if totals[k] == 0 or tris[k] is None or len(tris[k]) == 0:
            out[i] = _EMPTY_MESH
          else:
            out[i] = _weld(tris[k], anisotropy, offsets[i])
  return out


def marching_cubes_batch(
  masks, anisotropy=(1.0, 1.0, 1.0), offsets=None, batch_size: int = 16,
):
  """Batched marching cubes: binary (x, y, z) masks (a list of numpy
  arrays or a ``LabelMasks``) → one (vertices (V,3) float32, faces (F,3)
  uint32) per mask, identical to ``marching_cubes`` on each."""
  return _isosurface_batch(masks, anisotropy, offsets, batch_size, "cubes")


def marching_tetrahedra_batch(
  masks, anisotropy=(1.0, 1.0, 1.0), offsets=None, batch_size: int = 16,
):
  """Batched marching tetrahedra, as ``marching_cubes_batch``."""
  return _isosurface_batch(masks, anisotropy, offsets, batch_size, "tetrahedra")


def marching_cubes(
  mask: np.ndarray, anisotropy=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0)
) -> Tuple[np.ndarray, np.ndarray]:
  """Binary mask (x, y, z) → (vertices (V,3) float32, faces (F,3) uint32).

  256-case marching cubes. Vertices in physical units:
  (voxel + offset) * anisotropy. Watertight over the mask interior; pad
  with a zero shell to close surfaces at the array boundary."""
  return marching_cubes_batch([mask], anisotropy, [offset])[0]


def marching_tetrahedra(
  mask: np.ndarray, anisotropy=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0)
) -> Tuple[np.ndarray, np.ndarray]:
  """Binary mask (x, y, z) → (vertices, faces) by the 6-tet decomposition
  (about twice the triangles of marching cubes for the same surface)."""
  return marching_tetrahedra_batch([mask], anisotropy, [offset])[0]


# ---------------------------------------------------------------------------
# the labels of a cutout


_SIGN = -(1 << 63)


def labels_on_device(img: np.ndarray, pad_lo, pad_hi, dev):
  """(x, y, z) labels -> (z, y, x) int64 on ``dev``, zero-padded by
  ``pad_lo`` / ``pad_hi`` voxels ((x, y, z) each), and whether the int64
  holds uint64 bits. Unsigned labels narrower than 64 bits travel as the
  signed type of their width and are widened on the device."""
  zyx = np.ascontiguousarray(img.transpose(2, 1, 0))
  flip = zyx.dtype == np.uint64
  width = zyx.dtype.itemsize
  unsigned = zyx.dtype.kind == "u" and width > 1
  if unsigned:
    zyx = zyx.view(f"i{width}")
  with transfer_span("h2d", zyx.nbytes, dev):
    src = torch.from_numpy(zyx).to(dev)
  Z, Y, X = (s + lo + hi for s, lo, hi in zip(src.shape, pad_lo[::-1], pad_hi[::-1]))
  with execute_span("labels.widen", Z * Y * X, 8 * Z * Y * X, dev):
    src = src.to(torch.int64)
    if unsigned and width < 8:
      src &= (1 << (8 * width)) - 1
    seg = torch.zeros((Z, Y, X), dtype=torch.int64, device=dev)
    seg[
      pad_lo[2] : Z - pad_hi[2], pad_lo[1] : Y - pad_hi[1], pad_lo[0] : X - pad_hi[0]
    ] = src
  if seg.is_cuda:
    torch.cuda.synchronize(seg.device)
  return seg, flip


def label_boxes(seg: torch.Tensor, flip_sign: bool):
  """The labels of one (z, y, x) int64 cutout on the device: their unique
  values with voxel counts, the dense renumbering and each dense id's
  bounding box.

  ``flip_sign``: the tensor holds uint64 bits; flipping the sign bit makes
  the int64 sort the uint64 order (ids at or above 2^63 included).

  Returns (labels int64 numpy (U,) in ascending order of the source's
  values, counts int64 numpy (U,), dense (z, y, x) int32 on the device
  with 0 for label 0 and 1..n for the nonzero labels in ascending order
  (signed labels below 0 included), lo and hi int64 numpy (n + 1, 3): the
  (x, y, z) least and greatest coordinate plus one of each dense id, as
  ``ndimage.find_objects``'s slices).
  """
  with execute_span("labels.boxes", seg.numel(), seg.numel() * 8, seg.device,
                    signature=(tuple(seg.shape),)):
    return _label_boxes(seg, flip_sign)


def _label_boxes(seg: torch.Tensor, flip_sign: bool):
  key = torch.bitwise_xor(seg, _SIGN) if flip_sign else seg
  uniq, inverse, counts = torch.unique(
    key.reshape(-1), sorted=True, return_inverse=True, return_counts=True
  )
  del key
  if flip_sign:
    uniq = torch.bitwise_xor(uniq, _SIGN)
  labels = uniq.cpu().numpy()
  zero = np.flatnonzero(labels == 0)
  if not len(zero):
    inverse += 1
  elif zero[0] > 0:
    # signed labels below 0 sort before it: they take dense ids 1..p
    p = int(zero[0])
    inverse = torch.where(inverse < p, inverse + 1, inverse.masked_fill(inverse == p, 0))
  n = len(labels) - len(zero)
  lo, hi = scatter_boxes(inverse, seg.shape, n)
  dense = inverse.view(seg.shape).to(torch.int32)
  del inverse
  return labels, counts.cpu().numpy(), dense, lo.cpu().numpy(), hi.cpu().numpy()


def label_bboxes(labels: np.ndarray, dev=None):
  """{label: (slice, slice, slice)} of every nonzero label of an (x, y, z)
  cutout, computed on ``dev`` (the port's device by default): the
  ``ndimage.find_objects`` slices of the JAX package's
  ``ops.remap.label_bboxes``, which the cross-section pass and
  ``CompressedLabels`` use."""
  dev = get_device() if dev is None else dev
  seg, flip = labels_on_device(labels, (0, 0, 0), (0, 0, 0), dev)
  uniq, _counts, dense, lo, hi = label_boxes(seg, flip)
  del dense, seg
  ids = uniq.view(np.uint64) if flip else uniq
  ids = ids[ids != 0]
  return {
    int(v): tuple(slice(int(a), int(b)) for a, b in zip(lo[i + 1], hi[i + 1]))
    for i, v in enumerate(ids.tolist())
  }


def scatter_boxes(ids: torch.Tensor, shape, n: int):
  """Each id 0..n's box among the flat int64 ids of a (z, y, x) volume of
  ``shape``: int64 (n + 1, 3) tensors on the ids' device, the (x, y, z)
  least coordinate and the greatest plus one, as ``ndimage.find_objects``'s
  slices (an absent id keeps the volume's largest extent and 0)."""
  Z, Y, X = shape
  lo = torch.full((3, n + 1), max(X, Y, Z), dtype=torch.int32, device=ids.device)
  hi = torch.full((3, n + 1), -1, dtype=torch.int32, device=ids.device)
  for a, (size, view) in enumerate(
    ((X, (1, 1, X)), (Y, (1, Y, 1)), (Z, (Z, 1, 1)))
  ):
    coord = torch.arange(size, dtype=torch.int32, device=ids.device)
    coord = coord.view(view).expand(Z, Y, X).reshape(-1)
    lo[a].scatter_reduce_(0, ids, coord, "amin")
    hi[a].scatter_reduce_(0, ids, coord, "amax")
    del coord
  return lo.T.to(torch.int64), hi.T.to(torch.int64) + 1


def unique_on_device(img: np.ndarray, dev, return_inverse: bool = False,
                     return_counts: bool = False):
  """``np.unique`` of (x, y, z) integer labels, computed on ``dev``.

  Returns a tuple: the unique labels (numpy, ``img``'s dtype, in numpy's
  ascending order: uint64 ids at or above 2^63 last), then, as asked, the
  inverse ((z, y, x) int64 on ``dev``: each voxel's index into the
  labels) and the voxel counts (int64 numpy).

  Float labels take ``np.unique`` on the host, as the JAX package does:
  its equal floats (-0.0 and 0.0) and the representative it keeps of them
  are what the callers (the census, ``dilate``) must reproduce."""
  if img.dtype.kind == "f":
    res = np.unique(img, return_inverse=return_inverse, return_counts=return_counts)
    res = res if isinstance(res, tuple) else (res,)
    out = [res[0]]
    rest = list(res[1:])
    if return_inverse:
      inv = rest.pop(0).reshape(img.shape).transpose(2, 1, 0)
      out.append(torch.from_numpy(np.ascontiguousarray(inv)).to(dev))
    if return_counts:
      out.append(rest.pop(0).astype(np.int64))
    return tuple(out)
  if img.dtype.kind not in "biu":
    raise ValueError(f"labels must be integers or floats, not {img.dtype}")
  seg, flip = labels_on_device(img, (0, 0, 0), (0, 0, 0), dev)
  key = torch.bitwise_xor(seg, _SIGN) if flip else seg
  del seg
  res = torch.unique(
    key.reshape(-1), sorted=True, return_inverse=return_inverse,
    return_counts=return_counts,
  )
  shape = key.shape
  del key
  res = res if isinstance(res, tuple) else (res,)
  uniq = res[0]
  if flip:
    uniq = torch.bitwise_xor(uniq, _SIGN)
  uniq = uniq.cpu().numpy()
  out = [uniq.view(np.uint64) if flip else uniq.astype(img.dtype)]
  rest = list(res[1:])
  if return_inverse:
    out.append(rest.pop(0).view(shape))
  if return_counts:
    out.append(rest.pop(0).cpu().numpy())
  return tuple(out)
