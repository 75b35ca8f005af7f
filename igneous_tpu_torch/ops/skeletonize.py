"""TEASAR skeletonization: the EDT and the per-voxel label work on the
port's device, path tracing on the host.

The port's own copy of ``igneous_tpu/ops/skeletonize.py`` (kimimaro
parity), producing the same skeletons byte for byte. Inside
``skeletonize`` the cutout goes to the device once; there the
whole-cutout multilabel EDT (``ops.edt``, the CUDA ``edt_pass`` kernel on
the card) and the labels' renumbering and bounding boxes
(``ops.mesh.label_boxes``: ``np.unique`` + ``renumber`` +
``find_objects``) run, and only the distance field and the boxes come
back. Tracing stays on the host, as in the reference: the penalty field
(PDRF), the 26-connected foreground graph (``csrc/fggraph.cpp``), Dijkstra
(scipy, and the incremental multi-source update of ``csrc/dijkstra.cpp``)
and path invalidation. Both host libraries build with g++ at first use
(``ops._build``); a failed build raises.

Algorithm per label (TEASAR with kimimaro's "rolling invalidation ball"):
  1. EDT of the mask (anisotropic, black border).
  2. root = voxel farthest (graph distance) from an arbitrary start.
  3. penalty field PDRF = const * (1 - edt/max_edt)^16: paths prefer the
     center of the object.
  4. repeat until every voxel is captured: take the farthest uncaptured
     voxel, trace its penalized-shortest path to the existing tree, and
     invalidate voxels within scale*edt + const of the new path vertices.

``voxel_graph`` (uint32 direction bitfields, ``ops.ccl.graph_bit``
layout: the graphene autapse fix's chunk-graph connectivity) removes the
foreground-graph edges whose bit is unset at the source voxel; every
component of the graph that remains is traced.

Stage timers (``telemetry``): h2d, edt, labels (unique, renumber, boxes),
d2h, trace; counters: labels (traced), vertices.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from scipy import ndimage
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components as graph_components
from scipy.sparse.csgraph import dijkstra

from .. import telemetry
from ..device import get_device
from ..observability.device import execute_span, transfer_span
from ..skeleton_io import Skeleton
from . import _build
from .ccl import graph_bit
from .edt import distance_field
from .edt import edt as device_edt
from .mesh import label_boxes, labels_on_device

PDRF_EXPONENT = 16


class TeasarParams:
  """TEASAR tuning knobs, mirroring the kimimaro teasar_params dict the
  reference forwards verbatim: path-invalidation scale/const, PDRF
  shaping, soma handling thresholds (all physical units), and a
  path-count cap."""

  def __init__(
    self,
    scale: float = 4.0,
    const: float = 500.0,  # physical units (nm)
    pdrf_scale: float = 100000.0,
    pdrf_exponent: int = PDRF_EXPONENT,
    soma_detection_threshold: float = 1100.0,
    soma_acceptance_threshold: float = 3500.0,
    soma_invalidation_scale: float = 2.0,
    soma_invalidation_const: float = 300.0,
    max_paths: Optional[int] = None,
  ):
    self.scale = scale
    self.const = const
    self.pdrf_scale = pdrf_scale
    self.pdrf_exponent = pdrf_exponent
    self.soma_detection_threshold = soma_detection_threshold
    self.soma_acceptance_threshold = soma_acceptance_threshold
    self.soma_invalidation_scale = soma_invalidation_scale
    self.soma_invalidation_const = soma_invalidation_const
    self.max_paths = max_paths

  KNOWN = (
    "scale", "const", "pdrf_scale", "pdrf_exponent",
    "soma_detection_threshold", "soma_acceptance_threshold",
    "soma_invalidation_scale", "soma_invalidation_const", "max_paths",
  )

  @classmethod
  def from_dict(cls, d: Optional[dict]) -> "TeasarParams":
    """Unknown keys are ignored with a warning instead of failing every
    queued task."""
    d = dict(d or {})
    unknown = set(d) - set(cls.KNOWN)
    if unknown:
      import warnings

      warnings.warn(
        f"TeasarParams: ignoring unsupported keys {sorted(unknown)}",
        stacklevel=2,
      )
    return cls(**{k: v for k, v in d.items() if k in cls.KNOWN})


def _positive_deltas():
  """The 13 positive-lex neighbor deltas with their voxel_graph bits:
  [((dx, dy, dz), bit), ...]."""
  out = []
  for dx in (-1, 0, 1):
    for dy in (-1, 0, 1):
      for dz in (-1, 0, 1):
        if (dx, dy, dz) <= (0, 0, 0):
          continue
        out.append(((dx, dy, dz), graph_bit((dx, dy, dz))))
  return out


def fggraph_lib() -> ctypes.CDLL:
  """``csrc/fggraph.cpp``, built at first use."""
  lib = _build.load("fggraph")
  if not getattr(lib, "_configured", False):
    lib.ig_fggraph.restype = ctypes.c_int64
    lib.ig_fggraph.argtypes = [
      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_int64,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_int32,
    ]
    lib._configured = True
  return lib


def dijkstra_lib() -> ctypes.CDLL:
  """``csrc/dijkstra.cpp``, built at first use."""
  lib = _build.load("dijkstra")
  if not getattr(lib, "_configured", False):
    lib.igdij_update.restype = ctypes.c_int
    lib.igdij_update.argtypes = [
      ctypes.c_int64,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_int64,
    ]
    lib._configured = True
  return lib


def _foreground_graph(mask: np.ndarray, pdrf: np.ndarray, anisotropy, voxel_graph=None):
  """26-connected symmetric CSR graph over the foreground voxels of
  ``mask`` (node ids: C-order scan positions), built by
  ``csrc/fggraph.cpp``; edge weight = mean endpoint penalty * physical
  step length; ``voxel_graph`` drops the edges whose direction bit is
  unset at the source voxel. Returns (graph or None when it has no edge,
  the flat indices of the foreground voxels)."""
  lib = fggraph_lib()
  idx = np.full(mask.size, -1, dtype=np.int64)
  fg = np.flatnonzero(mask.reshape(-1))
  idx[fg] = np.arange(len(fg))
  n = len(fg)
  w = np.asarray(anisotropy, dtype=np.float64)
  pairs = _positive_deltas()
  deltas = np.ascontiguousarray(
    [d for d, _b in pairs], dtype=np.int8
  ).reshape(-1)
  lens = np.ascontiguousarray(
    [float(np.linalg.norm(w * np.asarray(d))) for d, _b in pairs],
    dtype=np.float64,
  )
  bits = np.ascontiguousarray([b for _d, b in pairs], dtype=np.int32)
  pdrf_c = np.ascontiguousarray(pdrf, dtype=np.float32)
  vg = (
    None if voxel_graph is None
    else np.ascontiguousarray(voxel_graph, dtype=np.uint32)
  )
  indptr = np.zeros(n + 1, dtype=np.int64)

  def call(indices, weights, fill):
    return lib.ig_fggraph(
      mask.shape[0], mask.shape[1], mask.shape[2],
      idx.ctypes.data_as(ctypes.c_void_p),
      pdrf_c.ctypes.data_as(ctypes.c_void_p),
      None if vg is None else vg.ctypes.data_as(ctypes.c_void_p),
      deltas.ctypes.data_as(ctypes.c_void_p),
      lens.ctypes.data_as(ctypes.c_void_p),
      bits.ctypes.data_as(ctypes.c_void_p),
      n,
      indptr.ctypes.data_as(ctypes.c_void_p),
      None if indices is None else indices.ctypes.data_as(ctypes.c_void_p),
      None if weights is None else weights.ctypes.data_as(ctypes.c_void_p),
      fill,
    )

  nnz = call(None, None, 0)
  if nnz == 0:
    return None, fg
  indices = np.empty(nnz, dtype=np.int32)
  weights = np.empty(nnz, dtype=np.float64)
  call(indices, weights, 1)
  g = csr_matrix((weights, indices, indptr), shape=(n, n))
  # canonical sorted rows: dijkstra's equal-distance tie-breaking follows
  # storage order, so rows must be stored as the JAX package stores them
  g.sort_indices()
  return g, fg


def skeletonize_mask(
  mask: np.ndarray,
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  params: Optional[TeasarParams] = None,
  offset: Sequence[float] = (0.0, 0.0, 0.0),
  edt_field: Optional[np.ndarray] = None,
  extra_targets: Optional[np.ndarray] = None,
  voxel_graph: Optional[np.ndarray] = None,
  fix_branching: bool = True,
) -> Skeleton:
  """Skeletonize one binary object. Vertices come out in physical units:
  (voxel + offset) * anisotropy. ``edt_field`` lets callers supply a
  precomputed EDT (``skeletonize`` passes its whole-cutout field).

  ``extra_targets``: (k, 3) voxel coords that MUST become skeleton
  vertices with a traced path to the tree: the border pins that make
  adjacent tasks' skeletons weld at shared overlap planes.

  ``fix_branching``: recompute the penalized shortest-path field from the
  ENTIRE current tree before each new path (multi-source Dijkstra), so
  branches attach at the correct centerline junction. False = one
  predecessor tree per component, faster, slightly off-center branch
  points."""
  params = params or TeasarParams()
  mask = np.ascontiguousarray(mask.astype(bool))
  if not mask.any():
    return Skeleton()

  dt = edt_field if edt_field is not None else device_edt(
    mask.astype(np.uint8), anisotropy, black_border=True
  )

  # every 26-connected piece of the label gets its own trace, cropped to
  # its bounding box
  comps, ncomp = ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
  if ncomp > 1:
    pieces = []
    for ci, sl in enumerate(ndimage.find_objects(comps), start=1):
      if sl is None:
        continue
      lo = np.array([s.start for s in sl])
      sub_targets = None
      if extra_targets is not None and len(extra_targets):
        et = np.asarray(extra_targets, dtype=np.int64)
        hi = np.array([s.stop for s in sl])
        keep = ((et >= lo) & (et < hi)).all(axis=1)
        sub_targets = et[keep] - lo
      piece = _skeletonize_component(
        comps[sl] == ci, dt[sl], anisotropy, params,
        np.asarray(offset, np.float32) + lo.astype(np.float32),
        sub_targets,
        None if voxel_graph is None else voxel_graph[sl],
        fix_branching,
      )
      if not piece.empty:
        pieces.append(piece)
    if not pieces:
      return Skeleton()
    return Skeleton.simple_merge(pieces).consolidate()
  return _skeletonize_component(
    mask, dt, anisotropy, params, offset, extra_targets, voxel_graph,
    fix_branching,
  )


class _IncrementalDijkstra:
  """Warm-field multi-source shortest-path forest over a CSR graph
  (``csrc/dijkstra.cpp``). Adding sources S to an existing multi-source
  field only improves distances in the region closer to S, so re-seeding
  the heap against the warm field relaxes exactly that region: the result
  equals a cold recompute from all sources so far, which is what
  fix_branching's per-path forest regrow needs."""

  def __init__(self, graph):
    self.lib = dijkstra_lib()
    g = graph.tocsr()
    self.n = g.shape[0]
    self.indptr = np.ascontiguousarray(g.indptr, dtype=np.int64)
    self.indices = np.ascontiguousarray(g.indices, dtype=np.int32)
    self.weights = np.ascontiguousarray(g.data, dtype=np.float64)
    self.dist = np.full(self.n, np.inf, dtype=np.float64)
    self.pred = np.full(self.n, -1, dtype=np.int32)

  def update(self, sources) -> None:
    src = np.ascontiguousarray(sources, dtype=np.int64)
    rc = self.lib.igdij_update(
      self.n,
      self.indptr.ctypes.data_as(ctypes.c_void_p),
      self.indices.ctypes.data_as(ctypes.c_void_p),
      self.weights.ctypes.data_as(ctypes.c_void_p),
      self.dist.ctypes.data_as(ctypes.c_void_p),
      self.pred.ctypes.data_as(ctypes.c_void_p),
      src.ctypes.data_as(ctypes.c_void_p),
      len(src),
    )
    if rc != 0:
      raise ValueError("igdij_update: source index out of range")


def _skeletonize_component(
  mask: np.ndarray,
  dt: np.ndarray,
  anisotropy,
  params: TeasarParams,
  offset,
  extra_targets,
  voxel_graph=None,
  fix_branching: bool = True,
) -> Skeleton:
  dt = np.where(mask, dt, 0.0)
  dmax = float(dt.max())
  if dmax <= 0:
    return Skeleton()

  pdrf = (
    params.pdrf_scale * (1.0 - dt / (1.05 * dmax)) ** params.pdrf_exponent
  ).astype(np.float32) + 1e-5
  pdrf[~mask] = np.float32(np.inf)

  graph, fg = _foreground_graph(mask, pdrf, anisotropy, voxel_graph)
  n = len(fg)
  if graph is None or n == 1:
    # a single voxel: degenerate one-vertex skeleton
    coords = np.array(np.unravel_index(fg, mask.shape)).T.astype(np.float32)
    verts = (coords + np.asarray(offset, np.float32)) * np.asarray(
      anisotropy, np.float32
    )
    return Skeleton(verts, np.zeros((0, 2), np.uint32),
                    radii=dt.reshape(-1)[fg])

  coords = np.array(np.unravel_index(fg, mask.shape)).T  # (n, 3) voxel
  phys = coords.astype(np.float32) * np.asarray(anisotropy, np.float32)

  edt_flat = dt.reshape(-1)[fg]
  inval_radius = params.scale * edt_flat + params.const

  flat_targets = None
  if extra_targets is not None and len(extra_targets):
    flat_targets = np.ravel_multi_index(
      np.asarray(extra_targets, dtype=np.int64).T, mask.shape
    )

  ncomp_g, comp_ids = graph_components(graph, directed=False)

  # soma mode (kimimaro soma_acceptance_threshold): a very thick object
  # is a cell body: root at the EDT maximum, one big invalidation ball,
  # radial paths to whatever pokes out
  soma_node = None
  if (
    params.soma_acceptance_threshold
    and dmax > params.soma_acceptance_threshold
  ):
    soma_node = int(np.argmax(edt_flat))

  paths = []
  roots = []
  on_tree = np.zeros(n, dtype=bool)
  max_paths = params.max_paths or n
  # one warm field shared across graph components: they are edge-disjoint,
  # so a later component's updates can never leak into (or read) another's
  inc = _IncrementalDijkstra(graph) if fix_branching else None
  for c in range(ncomp_g):
    in_comp = comp_ids == c
    nodes = np.flatnonzero(in_comp)
    if soma_node is not None and in_comp[soma_node]:
      root = soma_node
    else:
      # root: farthest voxel (unweighted hops) from an arbitrary start
      d0 = dijkstra(graph, indices=int(nodes[0]), unweighted=True)
      root = int(np.argmax(np.where(np.isfinite(d0), d0, -1)))
    roots.append(root)

    captured = ~in_comp  # other components are off-limits for this trace
    captured = captured.copy()
    captured[root] = True
    tree_c = np.zeros(n, dtype=bool)  # this component's current tree
    tree_c[root] = True

    if root == soma_node:
      r = (
        params.soma_invalidation_scale * edt_flat[root]
        + params.soma_invalidation_const
      )
      d2 = ((phys - phys[root]) ** 2).sum(-1)
      captured |= d2 <= r * r

    # penalized distances + shortest-path forest: with fix_branching the
    # forest is regrown from the WHOLE current tree before every path;
    # without it one root-rooted tree serves every path
    if fix_branching:
      inc.update([root])
      dist, pred = inc.dist, inc.pred
    else:
      dist, pred = dijkstra(graph, indices=root, return_predecessors=True)

    # ``remaining`` and its phys rows shrink as the invalidation pass
    # captures voxels
    remaining = np.flatnonzero(~captured)
    rem_phys = phys[remaining]
    for _ in range(max_paths):
      alive = ~captured[remaining]
      if not alive.all():
        remaining = remaining[alive]
        rem_phys = rem_phys[alive]
      if len(remaining) == 0:
        break
      target = int(remaining[np.argmax(dist[remaining])])
      # walk the predecessor forest from target back onto the tree
      path = [target]
      cur = target
      while pred[cur] >= 0 and not (tree_c[cur] if fix_branching
                                    else captured[cur]):
        cur = int(pred[cur])
        path.append(cur)
      path = np.asarray(path, dtype=np.int64)
      paths.append(path)
      tree_c[path] = True
      # rolling invalidation ball: capture voxels near the new centerline
      ball = inval_radius[path]  # (p,)
      rem = remaining
      rp = rem_phys
      for start in range(0, len(path), 512):
        seg = path[start : start + 512]
        rchunk = ball[start : start + 512]
        # exact bbox prefilter: no voxel outside the chunk's bounding box
        # padded by its largest ball radius can be captured
        rmax = float(rchunk.max())
        sp = phys[seg]
        lo = sp.min(axis=0) - rmax
        hi = sp.max(axis=0) + rmax
        near = np.flatnonzero(
          ((rp >= lo) & (rp <= hi)).all(axis=1)
        )
        if len(near) == 0:
          continue
        cand = rem[near]
        # ||c - s||^2 via GEMM, in float64
        cp = rp[near].astype(np.float64)
        ps = sp.astype(np.float64)
        d2 = (
          (cp * cp).sum(1)[:, None]
          + (ps * ps).sum(1)[None, :]
          - 2.0 * (cp @ ps.T)
        )  # (c, p)
        hit = (d2 <= (rchunk[None, :].astype(np.float64) ** 2)).any(axis=1)
        captured[cand[hit]] = True
        if hit.any():
          keep = np.ones(len(rem), dtype=bool)
          keep[near[hit]] = False
          rem = rem[keep]
          rp = rp[keep]
        if len(rem) == 0:
          break
      remaining = rem  # survivors; path members prune at the loop top
      rem_phys = rp
      captured[path] = True
      if fix_branching and not captured.all():
        # warm-field update from just the new branch
        inc.update(path)
        dist, pred = inc.dist, inc.pred

    # forced targets: path each one into this component's tree regardless
    # of invalidation
    if flat_targets is not None:
      for p in paths:
        on_tree[p] = True
      on_tree[root] = True
      pos = np.searchsorted(fg, flat_targets)
      for p, t in zip(pos, flat_targets):
        if p >= n or fg[p] != t or not in_comp[p]:
          continue
        path = [int(p)]
        cur = int(p)
        while pred[cur] >= 0 and not on_tree[cur]:
          cur = int(pred[cur])
          path.append(cur)
        if len(path) > 1:
          arr = np.asarray(path, dtype=np.int64)
          paths.append(arr)
          on_tree[arr] = True

  # assemble skeleton from paths
  verts = (coords.astype(np.float32) + np.asarray(offset, np.float32)) * \
    np.asarray(anisotropy, np.float32)
  edges = []
  for path in paths:
    edges.append(np.stack([path[:-1], path[1:]], axis=1))
  edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)

  used = np.unique(np.concatenate([edges.reshape(-1), roots]))
  remap = np.full(n, -1, dtype=np.int64)
  remap[used] = np.arange(len(used))
  skel = Skeleton(
    verts[used],
    remap[edges].astype(np.uint32),
    radii=edt_flat[used],
    vertex_types=np.zeros(len(used), np.uint8),
  )
  return skel.consolidate()


def cutout_labels(labels: np.ndarray, anisotropy, edt_field=None):
  """The device half of ``skeletonize``: the cutout goes to the device
  once, where its whole EDT (black border) and its labels' renumbering
  and boxes are computed; only the field and the boxes come back.

  Returns (field: float32 (x, y, z) numpy, labels: the nonzero labels in
  ascending order as Python ints, counts: their voxel counts, lo and hi:
  int64 (n, 3) numpy, each label's (x, y, z) box as ``find_objects``'s
  slices). ``edt_field`` given skips the EDT and returns it as the field.
  """
  dev = get_device()
  with telemetry.stage("h2d"):
    seg, flip = labels_on_device(labels, (0, 0, 0), (0, 0, 0), dev)
  field = None
  if edt_field is None:
    with telemetry.stage("edt"):
      with execute_span("edt.sq", seg.numel(), seg.numel() * 12, dev,
                        signature=(tuple(seg.shape),)):
        field = distance_field(seg, anisotropy, black_border=True)
      if seg.is_cuda:
        torch.cuda.synchronize(dev)
  with telemetry.stage("labels"):
    uniq, counts, dense, lo, hi = label_boxes(seg, flip)
    del dense, seg
  with telemetry.stage("d2h"):
    if field is not None:
      with transfer_span("d2h", field.numel() * 4, dev):
        edt_field = field.cpu().numpy().transpose(2, 1, 0)
      del field
  ids = uniq.view(np.uint64) if flip else uniq.astype(labels.dtype)
  nonzero = ids != 0
  return (
    edt_field, [int(v) for v in ids[nonzero]], counts[nonzero], lo[1:], hi[1:],
  )


def skeletonize(
  labels: np.ndarray,
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  params: Optional[TeasarParams] = None,
  offset: Sequence[float] = (0.0, 0.0, 0.0),
  object_ids: Optional[Sequence[int]] = None,
  dust_threshold: int = 0,
  extra_targets_per_label: Optional[Dict[int, np.ndarray]] = None,
  parallel: int = 1,
  progress: bool = False,
  voxel_graph: Optional[np.ndarray] = None,
  edt_field: Optional[np.ndarray] = None,
  fix_branching: bool = True,
  fix_avocados: bool = False,
) -> Dict[int, Skeleton]:
  """Skeletonize every label in a volume -> {label: Skeleton}.

  The whole-cutout EDT and the labels' boxes come from the device
  (``cutout_labels``); per-label tracing crops to each label's bounding
  box, on ``parallel`` host threads (scipy and numpy release the
  interpreter lock). ``edt_field`` supplies a precomputed whole-cutout
  field instead of the device's.

  ``fix_avocados``: a soma whose nucleus was segmented as a separate label
  skeletonizes like an avocado (the EDT sees a hollow shell). For every
  soma-candidate label (max EDT >= soma_detection_threshold), labels
  wholly engulfed by its filled hull are absorbed into it (and dropped
  from the output), background holes are filled, and the label's EDT is
  recomputed on the solid mask. With ``object_ids``, only requested
  labels are soma candidates."""
  del progress
  params = params or TeasarParams()
  labels = np.asarray(labels)
  if labels.ndim == 4:
    labels = labels[..., 0]

  whole_edt, ids, counts, lo, hi = cutout_labels(labels, anisotropy, edt_field)
  slices = [
    tuple(slice(int(a), int(b)) for a, b in zip(lo[i], hi[i]))
    for i in range(len(ids))
  ]
  count_of = dict(zip(ids, counts.tolist()))

  wanted = set(int(v) for v in object_ids) if object_ids else None

  absorbed: set = set()
  solid_masks: Dict[int, np.ndarray] = {}
  solid_edts: Dict[int, np.ndarray] = {}
  if fix_avocados:
    detect = float(params.soma_detection_threshold or 0.0)
    for label, sl in zip(ids, slices):
      # only requested labels can be somas: absorption then never steals
      # an explicitly requested label
      if wanted is not None and label not in wanted:
        continue
      crop = labels[sl]
      mask = crop == label
      filled = ndimage.binary_fill_holes(mask)
      added = filled & ~mask
      if not added.any():
        continue
      pit_labels = [
        int(lab)
        for lab in np.unique(crop[added])
        if int(lab) not in (0, label)
        and int(np.count_nonzero((crop == lab) & added)) == count_of[int(lab)]
      ]
      bg_holes = added & (crop == 0)
      if not pit_labels and not bg_holes.any():
        continue
      solid = mask | bg_holes
      if pit_labels:
        solid |= np.isin(crop, np.asarray(pit_labels, dtype=crop.dtype)) & added
      # soma candidacy is judged on the SOLID body
      edt_solid = device_edt(
        solid.astype(np.uint8), anisotropy, black_border=True
      )
      if float(edt_solid.max()) < detect:
        continue
      absorbed.update(pit_labels)
      solid_masks[label] = solid
      solid_edts[label] = edt_solid

  def trace(label: int, sl) -> Optional[tuple]:
    if label in absorbed:  # a nucleus swallowed by its soma
      return None
    if wanted is not None and label not in wanted:
      return None
    solid = label in solid_masks
    size = int(solid_masks[label].sum()) if solid else count_of[label]
    if dust_threshold and size < dust_threshold:
      return None
    if solid:
      mask = solid_masks[label]
      crop_edt = solid_edts[label]
    else:
      mask = labels[sl] == label
      crop_edt = np.where(mask, whole_edt[sl], 0.0)
    crop_offset = np.asarray(offset, np.float32) + np.asarray(
      [s.start for s in sl], np.float32
    )
    targets = None
    if extra_targets_per_label and label in extra_targets_per_label:
      t = np.asarray(extra_targets_per_label[label], dtype=np.int64)
      t = t - np.asarray([s.start for s in sl], dtype=np.int64)
      inside = np.all(
        (t >= 0) & (t < np.asarray(mask.shape, dtype=np.int64)), axis=1
      )
      targets = t[inside]
    skel = skeletonize_mask(
      mask, anisotropy, params, offset=crop_offset, edt_field=crop_edt,
      extra_targets=targets,
      voxel_graph=None if voxel_graph is None else voxel_graph[sl],
      fix_branching=fix_branching,
    )
    return None if skel.empty else (label, skel)

  jobs = list(zip(ids, slices))
  out: Dict[int, Skeleton] = {}
  with telemetry.stage("trace"):
    if parallel > 1 and len(jobs) > 1:
      import concurrent.futures as cf

      with cf.ThreadPoolExecutor(max_workers=int(parallel)) as pool:
        results = list(pool.map(lambda j: trace(*j), jobs))
    else:
      results = [trace(*job) for job in jobs]
  for result in results:
    if result is not None:
      out[result[0]] = result[1]
  telemetry.incr("skeleton.labels", len(out))
  telemetry.incr("skeleton.vertices", sum(len(s.vertices) for s in out.values()))
  return out
