"""Graphene (PyChunkGraph proofreading volume) support: host state.

The port's own copy of ``igneous_tpu/graphene.py``: the client registry
(``register_graphene_client``, ``graphene_client``, ``is_graphene``,
``watershed_path``), the in-process chunk graph ``LocalChunkGraph`` with
its client, ``use_local_chunkgraph`` and ``voxel_chunk_index``.
``LocalChunkGraph`` keeps the JAX package's state (``_events``,
``chunk_size``) and signatures (``get_roots``, ``get_l2_ids``,
``voxel_connectivity_graph``), so the repo's fake PyChunkGraph server
(``tests/fake_pcg_server.py``) serves it unchanged, and L2 ids are
numbered on first sight of each (root, chunk) pair in ``np.unique``
order, as there.

The lookups here are host dictionaries; the per-voxel work (the unique
ids of a cutout, their inverse, the voxel chunk index, the voxel graph's
shifted compares and the gathers back) runs on the device in
``volume.Volume.download`` and ``ops.ccl.voxel_connectivity_graph``, so a
client receives unique ids or unique (supervoxel, chunk) pairs.

Addressing: ``graphene://<watershed-layer-path>`` (a local graph
registered for that path) or ``graphene://https://server/...`` (the HTTP
client of ``graphene_http``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_GRAPHENE_CLIENT_FACTORY = None


def register_graphene_client(factory):
  """factory(cloudpath) → client implementing the GrapheneClient
  protocol, ALL of which the pipeline calls:
  - get_roots(supervoxels, timestamp) → uint64 root ids
  - get_l2_ids(supervoxels, voxel_chunks, timestamp) → uint64 L2 ids
  - voxel_connectivity_graph(supervoxels, connectivity, timestamp) →
    uint32 direction bitfields (ops.ccl.graph_bit layout)
  - chunk_size property → the chunk-graph's (x, y, z) chunk size
  """
  global _GRAPHENE_CLIENT_FACTORY
  _GRAPHENE_CLIENT_FACTORY = factory


def require_graphene_client(cloudpath: str) -> None:
  if _GRAPHENE_CLIENT_FACTORY is None:
    from .graphene_http import parse_graphene_server

    if parse_graphene_server(watershed_path(cloudpath)):
      return  # server-addressed: the HTTP client self-constructs
    raise NotImplementedError(
      f"{cloudpath!r}: graphene:// volumes need a chunk-graph client; "
      "address a PyChunkGraph server directly "
      "(graphene://https://server/...) or register one with "
      "igneous_tpu_torch.graphene.register_graphene_client(factory), "
      "e.g. "
      "use_local_chunkgraph(path, graph) for the in-process "
      "LocalChunkGraph."
    )


def graphene_client(cloudpath: str):
  require_graphene_client(cloudpath)
  if _GRAPHENE_CLIENT_FACTORY is not None:
    return _GRAPHENE_CLIENT_FACTORY(cloudpath)
  from .graphene_http import PCGClient, parse_graphene_server

  return PCGClient(parse_graphene_server(watershed_path(cloudpath)))


def is_graphene(cloudpath: str) -> bool:
  return cloudpath.startswith("graphene://")


def watershed_path(cloudpath: str) -> str:
  return cloudpath[len("graphene://"):] if is_graphene(cloudpath) else cloudpath


# ---------------------------------------------------------------------------
# in-process chunk graph (the test/dev server double)


class LocalChunkGraph:
  """Timestamped supervoxel chunk-graph (PyChunkGraph's public model).

  State is an EDGE SET over supervoxels — exactly how PCG represents
  agglomeration:
  - ``initial_edges`` seed the watershed region adjacency graph (the
    edges the original agglomeration accepted);
  - ``merge(a, b, t)`` adds an edge; ``split(group_a, group_b, t)``
    removes every edge crossing the partition;
  - roots as-of t = connected components of the edges active at t, so
    every historical state stays queryable;
  - ``voxel_connectivity_graph`` severs voxel adjacency where two
    touching supervoxels share NO active edge — including self-contacts
    of one object (the autapse case: same root, no direct edge);
  - L2 ids are stable per (root, chunk) via a first-sight registry, the
    granularity GrapheneMeshTask meshes at.
  """

  ROOT_BASE = np.uint64(1) << np.uint64(48)
  L2_BASE = np.uint64(1) << np.uint64(40)

  def __init__(
    self,
    initial_edges: Optional[Iterable[Sequence[int]]] = None,
    chunk_size: Sequence[int] = (64, 64, 64),
  ):
    self.chunk_size = tuple(int(c) for c in chunk_size)
    # (timestamp, kind, a, b); initial edges exist since forever
    self._events: List[Tuple[float, str, int, int]] = [
      (float("-inf"), "add", int(a), int(b)) for a, b in (initial_edges or [])
    ]
    self._cache: Dict[float, set] = {}
    self._root_cache: Dict[float, Dict[int, int]] = {}
    # (root, chunk) -> L2 id, assigned on first sight — the same pair
    # maps to the same id across every lookup, like a server's L2 table
    # (per-process state: the local double serves in-process pipelines;
    # multi-process workers need a real server)
    self._l2_registry: Dict[Tuple[int, int], int] = {}

  # -- edits ----------------------------------------------------------------

  def merge(self, sv_a: int, sv_b: int, timestamp: float):
    self._events.append((float(timestamp), "add", int(sv_a), int(sv_b)))
    self._events.sort(key=lambda e: e[0])
    self._cache.clear()
    self._root_cache.clear()

  def split(
    self, group_a: Sequence[int], group_b: Sequence[int], timestamp: float
  ):
    """Remove every edge crossing the partition (PCG split semantics)."""
    t = float(timestamp)
    ga = set(int(s) for s in group_a)
    gb = set(int(s) for s in group_b)
    for a, b in sorted(self._edges_at(t)):
      if (a in ga and b in gb) or (a in gb and b in ga):
        self._events.append((t, "remove", a, b))
    self._events.sort(key=lambda e: e[0])
    self._cache.clear()
    self._root_cache.clear()

  # -- graph state ----------------------------------------------------------

  def _edges_at(self, timestamp: Optional[float]) -> set:
    t = float("inf") if timestamp is None else float(timestamp)
    if t in self._cache:
      return self._cache[t]
    edges = set()
    for et, kind, a, b in self._events:
      if et > t:
        break
      pair = (min(a, b), max(a, b))
      if kind == "add":
        edges.add(pair)
      else:
        edges.discard(pair)
    self._cache[t] = edges
    return edges

  def _roots_at(self, timestamp: Optional[float]) -> Dict[int, int]:
    t = float("inf") if timestamp is None else float(timestamp)
    if t in self._root_cache:
      return self._root_cache[t]
    parent: Dict[int, int] = {}

    def find(x: int) -> int:
      while parent.setdefault(x, x) != x:
        parent[x] = parent.get(parent[x], parent[x])
        x = parent[x]
      return x

    for a, b in self._edges_at(t):
      ra, rb = find(a), find(b)
      if ra != rb:
        parent[max(ra, rb)] = min(ra, rb)
    flat = {sv: find(sv) for sv in list(parent)}
    self._root_cache[t] = flat
    return flat

  # -- lookups --------------------------------------------------------------

  def get_roots(
    self, supervoxels: np.ndarray, timestamp: Optional[float] = None
  ) -> np.ndarray:
    """Per-supervoxel root ids (uint64); 0 stays 0. Root ids live above
    ROOT_BASE so they can never collide with supervoxel ids."""
    mapping = self._roots_at(timestamp)
    sv = np.asarray(supervoxels, dtype=np.uint64)
    flat_in = sv.reshape(-1)
    uniq = np.unique(flat_in)
    remapped = np.array([
      0 if int(u) == 0
      else int(self.ROOT_BASE) + mapping.get(int(u), int(u))
      for u in uniq
    ], dtype=np.uint64)
    idx = np.searchsorted(uniq, flat_in)
    return remapped[idx].reshape(sv.shape)

  def voxel_connectivity_graph(
    self,
    supervoxels: np.ndarray,
    connectivity: int = 26,
    timestamp: Optional[float] = None,
  ) -> np.ndarray:
    """Per-voxel direction bitfields over the WATERSHED cutout: a bit is
    set when the neighbor is the same supervoxel or the two supervoxels
    share an active chunk-graph edge. Self-contacts of one object (no
    direct edge) stay severed: the autapse fix's input. The bits are
    computed on the port's device (``ops.ccl.voxel_connectivity_graph``);
    only the distinct neighbouring pairs reach ``allowed`` here."""
    from .ops.ccl import voxel_connectivity_graph as _vcg

    sv = np.asarray(supervoxels)
    edges = self._edges_at(timestamp)
    pair_ok_cache: Dict[Tuple[int, int], bool] = {}

    def allowed(pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
      same = pa == pb
      res = same.copy()
      diff = ~same & (pa != 0) & (pb != 0)
      if diff.any():
        da = pa[diff]
        db = pb[diff]
        lo = np.minimum(da, db)
        hi = np.maximum(da, db)
        pairs = np.stack([lo, hi], axis=-1)
        uniqp, inv = np.unique(pairs.reshape(-1, 2), axis=0, return_inverse=True)
        ok = np.array([
          pair_ok_cache.setdefault(
            (int(a), int(b)), (int(a), int(b)) in edges
          )
          for a, b in uniqp
        ], dtype=bool)
        res[diff] = ok[inv]
      return res

    return _vcg(sv, connectivity, pair_allowed=allowed)

  def get_l2_ids(
    self,
    supervoxels: np.ndarray,
    voxel_chunks: np.ndarray,
    timestamp: Optional[float] = None,
  ) -> np.ndarray:
    """Per-voxel L2 ids: stable per (root, chunk) pair. ``voxel_chunks``
    is the per-voxel linearized chunk index (same shape as supervoxels)."""
    roots = self.get_roots(supervoxels, timestamp)
    chunks = np.asarray(voxel_chunks, dtype=np.uint64)
    l2 = np.zeros_like(roots)
    fg = roots != 0
    if not fg.any():
      return l2
    pairs = np.stack([roots[fg], chunks[fg]], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    ids = np.array(
      [self._l2_id(int(r), int(c)) for r, c in uniq], dtype=np.uint64
    )
    l2[fg] = ids[inv]
    return l2

  def _l2_id(self, root: int, chunk: int) -> int:
    key = (root, chunk)
    if key not in self._l2_registry:
      self._l2_registry[key] = int(self.L2_BASE) + len(self._l2_registry)
    return self._l2_registry[key]


class LocalGrapheneClient:
  """GrapheneClient over a LocalChunkGraph (per-process registry)."""

  def __init__(self, cloudpath: str, graph: LocalChunkGraph):
    self.cloudpath = cloudpath
    self.graph = graph

  def get_roots(self, supervoxels, timestamp=None):
    return self.graph.get_roots(supervoxels, timestamp)

  def get_l2_ids(self, supervoxels, voxel_chunks, timestamp=None):
    return self.graph.get_l2_ids(supervoxels, voxel_chunks, timestamp)

  def voxel_connectivity_graph(self, supervoxels, connectivity=26,
                               timestamp=None, **placement):
    # placement (offset/downsample_ratio) matters only to clients that
    # shade graph-chunk planes; the edge-exact local graph ignores it
    del placement
    return self.graph.voxel_connectivity_graph(
      supervoxels, connectivity, timestamp
    )

  @property
  def chunk_size(self):
    return self.graph.chunk_size


_LOCAL_GRAPHS: Dict[str, LocalChunkGraph] = {}


def use_local_chunkgraph(cloudpath: str, graph: LocalChunkGraph):
  """Attach a LocalChunkGraph to serve one graphene:// path. Paths
  without a local graph fall through to whatever factory was registered
  before (a real PCG client is never clobbered), else the curated
  unregistered-client error."""
  _LOCAL_GRAPHS[cloudpath] = graph
  previous = _GRAPHENE_CLIENT_FACTORY

  def factory(path: str):
    if path in _LOCAL_GRAPHS:
      return LocalGrapheneClient(path, _LOCAL_GRAPHS[path])
    if previous is not None and previous is not factory:
      return previous(path)
    from .graphene_http import PCGClient, parse_graphene_server

    server = parse_graphene_server(watershed_path(path))
    if server:
      # server-addressed paths keep self-constructing the HTTP client
      # even while local graphs serve other paths in the same process
      return PCGClient(server)
    raise NotImplementedError(
      f"{path!r}: no LocalChunkGraph attached for this path (see "
      "use_local_chunkgraph) and no other graphene client registered."
    )

  register_graphene_client(factory)


def voxel_chunk_index(bbox_minpt, shape, chunk_size, scale=(1, 1, 1)) -> np.ndarray:
  """Per-voxel linearized chunk index for a cutout at global offset
  ``bbox_minpt`` with (x, y, z) ``shape``. ``scale`` converts mip-level
  voxel coordinates to the base resolution the chunk grid is defined at
  (the volume's downsample_ratio for that mip)."""
  cs = np.asarray(chunk_size, dtype=np.int64)
  mn = np.asarray(bbox_minpt, dtype=np.int64)
  sc = np.asarray(scale, dtype=np.int64)
  gx = (((mn[0] + np.arange(shape[0], dtype=np.int64)) * sc[0]) // cs[0])[:, None, None]
  gy = (((mn[1] + np.arange(shape[1], dtype=np.int64)) * sc[1]) // cs[1])[None, :, None]
  gz = (((mn[2] + np.arange(shape[2], dtype=np.int64)) * sc[2]) // cs[2])[None, None, :]
  return (gx + (gy << np.int64(20)) + (gz << np.int64(40))).astype(np.uint64)
