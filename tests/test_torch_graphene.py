"""The port's graphene:// support against the JAX package.

Both packages get their own chunk graph with the same initial edges,
merges and splits (``LocalChunkGraph``, served in-process or through the
repo's fake PyChunkGraph server, ``tests/fake_pcg_server.py``), over the
same watershed layer: tubes cut into chunk-local supervoxels, ids above
2^32 and at or above 2^63, two tubes merged through supervoxels that do
not touch (so where they touch, one root touches itself with no edge: an
autapse), a split and a merge at timestamps. Root and L2 ids, voxel
graphs, downloads, graphene meshes (``GrapheneMeshTask`` and ``mesh
forge``), skeletons with ``fix_autapses``, ``timestamp`` and
``root_ids_cloudpath``, agglomerated transfers (sharded ones too) and the
census are held byte for byte against the JAX package, and the PCG client
against the JAX package's over the wire (requests, dedupe, change log,
auth rotation, the reference-style voxel graph). Invalid combinations
raise the JAX package's exceptions before anything is written.
"""

import json
import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

from fake_pcg_server import FakePCGServer
from igneous_tpu import graphene as jax_graphene
from igneous_tpu import graphene_http as jax_http
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.ops.ccl import voxel_connectivity_graph as jax_vcg
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.volume import Volume as JaxVolume
from igneous_tpu_torch import device, graphene, graphene_http
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.lib import Bbox
from igneous_tpu_torch.ops.ccl import (
  graph_bit,
  voxel_connectivity_graph,
  voxel_connectivity_graph_plain,
)
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.storage_http import HttpError
from igneous_tpu_torch.tasks import SkeletonTask, TransferTask
from igneous_tpu_torch.volume import Volume

from test_torch_skeleton_tasks import FORGE, MERGE, tubes

GCS = (16, 24, 12)  # the chunk graph's chunk size: the layer is 4 x 2 x 2 chunks
T_MERGE, T_SPLIT = 10.0, 20.0


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.delenv("CAVE_TOKEN", raising=False)
  device.reset_device()
  yield
  device.reset_device()
  for mod in (jax_graphene, graphene):
    mod._GRAPHENE_CLIENT_FACTORY = None
    mod._LOCAL_GRAPHS.clear()


def watershed():
  """(supervoxels (x, y, z) uint64, initial edges, merges, splits): the
  tubes of ``tubes()`` cut at the graph chunks, each piece a supervoxel;
  each tube's pieces chained by edges; two touching tubes merged at
  T_MERGE through pieces far apart, a tube split at T_SPLIT."""
  lab = tubes()
  chunks = jax_graphene.voxel_chunk_index((0, 0, 0), lab.shape, GCS)
  fg = lab != 0
  pairs, inv = np.unique(np.stack([lab[fg], chunks[fg]], 1), axis=0, return_inverse=True)
  ids = np.array([
    int(l) + (k + 1) * 2**20 if int(l) >= 2**63 else 2**32 + int(l) * 1024 + k
    for k, (l, _c) in enumerate(pairs.tolist())
  ], dtype=np.uint64)
  assert len(np.unique(ids)) == len(ids)
  sv = np.zeros(lab.shape, np.uint64)
  sv[fg] = ids[inv.reshape(-1)]
  pieces = {}
  for (l, _c), s in zip(pairs.tolist(), ids.tolist()):
    pieces.setdefault(int(l), []).append(int(s))
  edges = [(p[i], p[i + 1]) for p in pieces.values() for i in range(len(p) - 1)]
  # two tubes that touch (along x), merged through their first and last pieces
  a, b = lab[:-1], lab[1:]
  touch = sorted({(int(x), int(y)) for x, y in zip(a[(a != b) & (a != 0) & (b != 0)],
                                                   b[(a != b) & (a != 0) & (b != 0)])})
  la, lb = touch[0]
  merges = [(pieces[la][0], pieces[lb][-1], T_MERGE)]
  multi = [p for p in pieces.values() if len(p) >= 3]
  splits = [([multi[0][0]], multi[0][1:], T_SPLIT)]
  return np.asfortranarray(sv), edges, merges, splits


def make_graph(mod, edges, merges, splits):
  g = mod.LocalChunkGraph(initial_edges=edges, chunk_size=GCS)
  for a, b, t in merges:
    g.merge(a, b, t)
  for ga, gb, t in splits:
    g.split(ga, gb, t)
  return g


def _sv_chunks(sv):
  chunks = jax_graphene.voxel_chunk_index((0, 0, 0), sv.shape, GCS)
  out = {}
  for s in np.unique(sv):
    if s:
      out[int(s)] = int(chunks[sv == s][0])
  return out


@pytest.fixture(params=["local", "http"])
def layers(request, tmp_path):
  """{"jax": graphene path, "port": graphene path, "root": {who: dir}}:
  one watershed layer per package, each with its own chunk graph, served
  in-process or through a fake PCG server of its own."""
  sv, edges, merges, splits = watershed()
  out, servers = {"root": {}, "servers": {}}, []
  for who, mod in (("jax", jax_graphene), ("port", graphene)):
    root = tmp_path / who
    inner = f"file://{root}"
    JaxVolume.from_numpy(sv, inner, resolution=(8, 8, 40), chunk_size=(16, 16, 12),
                         layer_type="segmentation")
    graph = make_graph(mod, edges, merges, splits)
    out["root"][who] = root
    if request.param == "local":
      out[who] = f"graphene://{inner}"
      mod.use_local_chunkgraph(out[who], graph)
    else:
      srv = FakePCGServer(graph, _sv_chunks(sv), data_dir=inner)
      srv.__enter__()
      servers.append(srv)
      out["servers"][who] = srv
      out[who] = f"graphene://{srv.base_url}"
  out["sv"] = sv
  out["backend"] = request.param
  yield out
  for srv in servers:
    srv.__exit__()


def _files(root: pathlib.Path, prefix=""):
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(pathlib.Path(root).rglob("*"))
    if p.is_file() and p.name != "provenance" and "integrity" not in p.relative_to(root).parts
    and str(p.relative_to(root)).startswith(prefix)
  }


def _same(a, b, prefix=""):
  ref, got = _files(a, prefix), _files(b, prefix)
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  return got


# -- the chunk graph and the voxel graph ---------------------------------------


def test_chunk_graph_roots_and_l2_ids_match_reference():
  sv, edges, merges, splits = watershed()
  jg = make_graph(jax_graphene, edges, merges, splits)
  pg = make_graph(graphene, edges, merges, splits)
  ids = np.unique(sv)
  assert ids[-1] >= 2**63 and (ids > 2**32).sum() > 10
  for ts in (None, 0, T_MERGE - 1, T_MERGE, T_SPLIT - 0.5, T_SPLIT + 1):
    assert np.array_equal(pg.get_roots(ids, ts), jg.get_roots(ids, ts))
  rng = np.random.default_rng(0)
  for call in range(4):  # L2 ids are numbered on first sight, call after call
    pick = rng.choice(ids, 40)
    chunks = rng.integers(0, 5, 40).astype(np.uint64)
    ts = (None, T_MERGE, T_SPLIT, 5.0)[call]
    got, ref = pg.get_l2_ids(pick, chunks, ts), jg.get_l2_ids(pick, chunks, ts)
    assert got.dtype == np.uint64 and np.array_equal(got, ref)
  assert pg._l2_registry == jg._l2_registry
  assert pg._events == jg._events and pg.chunk_size == jg.chunk_size
  roots = pg.get_roots(ids, None)
  assert len(np.unique(roots[ids != 0])) < len(ids) - 1  # agglomerated


@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("dtype", [np.uint64, np.uint32, np.int32])
@pytest.mark.parametrize("predicate", ["equal", "graph"])
def test_voxel_connectivity_graph_matches_reference(connectivity, dtype, predicate):
  rng = np.random.default_rng(connectivity)
  values = np.array([0, 3, 5, 9, 2**31 - 7], np.int64)
  if dtype == np.uint64:
    values = np.array([0, 3, 2**33 + 1, 2**63 + 5, 2**64 - 2**49], np.uint64)
  labels = values[rng.integers(0, len(values), (11, 9, 7))].astype(dtype)
  labels[2:6, 3:7, 1:5] = labels[2, 3, 1]  # a block of one label
  allowed = None
  if predicate == "graph":
    nz = [int(v) for v in np.unique(labels) if v != 0]
    edge = {(min(nz[0], nz[1]), max(nz[0], nz[1])), (min(nz[1], nz[-1]), max(nz[1], nz[-1]))}

    def allowed(a, b):  # elementwise over arrays of any shape
      return np.array([x == y or (min(x, y), max(x, y)) in edge
                       for x, y in zip(a.ravel().tolist(), b.ravel().tolist())],
                      dtype=bool).reshape(a.shape)
  got = voxel_connectivity_graph(labels, connectivity, allowed)
  ref = jax_vcg(labels, connectivity, allowed)
  assert got.dtype == np.uint32 and got.shape == labels.shape
  assert np.array_equal(got, ref)
  assert np.array_equal(voxel_connectivity_graph_plain(labels, connectivity, allowed), ref)
  assert (ref > 0).any()


def test_chunk_graph_voxel_graph_severs_the_autapse():
  sv, edges, merges, splits = watershed()
  jg = make_graph(jax_graphene, edges, merges, splits)
  pg = make_graph(graphene, edges, merges, splits)
  for ts in (None, 0.0, T_MERGE + 1):
    got = pg.voxel_connectivity_graph(sv, 26, ts)
    assert np.array_equal(got, jg.voxel_connectivity_graph(sv, 26, ts))
  # the merged tubes share a root after T_MERGE, yet their contact stays
  # severed: no edge joins the touching supervoxels
  (a, b, _t), = merges
  roots = pg.get_roots(np.asarray([a, b], np.uint64), T_MERGE + 1)
  assert roots[0] == roots[1]
  by_roots = voxel_connectivity_graph_plain(pg.get_roots(sv.reshape(-1), T_MERGE + 1).reshape(sv.shape), 26)
  assert ((by_roots & ~got) != 0).any()


# -- the PCG client over the wire ----------------------------------------------


def _both_clients(graphs, sv_chunks, **kw):
  srv_j = FakePCGServer(graphs[0], sv_chunks, **kw).__enter__()
  srv_p = FakePCGServer(graphs[1], sv_chunks, **kw).__enter__()
  return srv_j, srv_p, jax_http.PCGClient(srv_j.base_url), graphene_http.PCGClient(srv_p.base_url)


def test_pcg_client_timestamps_dedupe_and_change_log_match_reference():
  graphs = []
  for mod in (jax_graphene, graphene):
    g = mod.LocalChunkGraph(initial_edges=[(1, 2)])
    g.merge(2, 3, timestamp=10)
    g.split([1], [2, 3], timestamp=20)
    graphs.append(g)
  srv_j, srv_p, cj, cp = _both_clients(graphs, {1: 0, 2: 0, 3: 1})
  try:
    sv = np.zeros((64, 8, 8), np.uint64)
    sv[0:20], sv[20:40], sv[40:64] = 1, 2, 3
    for ts in (5, 15, 25, None):
      assert np.array_equal(cp.get_roots(np.unique(sv), ts), cj.get_roots(np.unique(sv), ts))
      assert np.array_equal(
        cp.get_l2_ids(np.unique(sv), None, ts), cj.get_l2_ids(np.unique(sv), None, ts))
    assert srv_p.requests == srv_j.requests
    assert sum(m == "POST" for m, _p in srv_p.requests) == 8  # one a call
    root = int(cp.get_roots(np.asarray([3], np.uint64))[0])
    assert cp.change_log(root) == cj.change_log(root)
    assert cp.chunk_size == cj.chunk_size == (64, 64, 64)
  finally:
    srv_j.__exit__()
    srv_p.__exit__()


def test_pcg_auth_late_provision_and_rotation_as_the_reference(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_TPU_SECRETS", str(tmp_path))
  graphene_http._AUTH_CACHE.clear()
  g = graphene.LocalChunkGraph(initial_edges=[(1, 2)])
  with FakePCGServer(g, {1: 0, 2: 0}, required_token="tok-v1") as srv:
    c = graphene_http.PCGClient(srv.base_url)
    sv = np.asarray([1, 2], np.uint64)
    with pytest.raises(HttpError) as exc:  # no token anywhere yet
      c.get_roots(sv)
    assert exc.value.status == 401
    secret = tmp_path / "cave-secret.json"
    secret.write_text(json.dumps({"token": "tok-v1"}))  # provisioned late
    assert len(np.unique(c.get_roots(sv))) == 1
    srv.required_token = "tok-v2"  # rotation: one retry with the re-read token
    secret.write_text(json.dumps({"token": "tok-v2"}))
    assert len(np.unique(c.get_roots(sv))) == 1
    (tmp_path / "cave-secret.json").unlink()
    (tmp_path / "chunkedgraph-secret.json").write_text(json.dumps({"token": "tok-v3"}))
    srv.required_token = "tok-v3"
    graphene_http._AUTH_CACHE.clear()
    assert len(np.unique(c.get_roots(sv))) == 1
    monkeypatch.setenv("CAVE_TOKEN", "tok-env")
    srv.required_token = "tok-env"
    assert len(np.unique(c.get_roots(sv))) == 1


@pytest.mark.parametrize("placement", [
  ((0, 0, 0), (1, 1, 1)), ((3, 5, 2), (1, 1, 1)), ((4, 6, 0), (2, 2, 1))])
def test_pcg_client_reference_style_voxel_graph_matches_reference(placement):
  sv, edges, merges, splits = watershed()
  graphs = [make_graph(m, edges, merges, splits) for m in (jax_graphene, graphene)]
  srv_j, srv_p, cj, cp = _both_clients(graphs, _sv_chunks(sv))
  offset, ratio = placement
  try:
    for ts in (None, T_MERGE + 1):
      got = cp.voxel_connectivity_graph(sv, 26, ts, offset=offset, downsample_ratio=ratio)
      ref = cj.voxel_connectivity_graph(sv, 26, ts, offset=offset, downsample_ratio=ratio)
      assert got.dtype == np.uint32 and np.array_equal(got, ref)
    assert srv_p.requests == srv_j.requests
  finally:
    srv_j.__exit__()
    srv_p.__exit__()
  # an L2 boundary inside one root connects on a graph-chunk plane
  g = graphene.LocalChunkGraph(initial_edges=[(1, 2)], chunk_size=(2, 8, 8))
  with FakePCGServer(g, {1: 0, 2: 1}) as srv:
    vg = graphene_http.PCGClient(srv.base_url).voxel_connectivity_graph(
      np.repeat(np.asarray([1, 1, 2, 2], np.uint64), 1).reshape(4, 1, 1), 6)
  assert (vg[0, 0, 0] >> graph_bit((1, 0, 0))) & 1 == 1
  assert (vg[1, 0, 0] >> graph_bit((1, 0, 0))) & 1 == 1


# -- downloads -------------------------------------------------------------------


def test_graphene_downloads_match_reference(layers):
  jv, pv = JaxVolume(layers["jax"]), Volume(layers["port"])
  assert pv.graphene is not None
  for box in (Bbox((0, 0, 0), (64, 48, 24)), Bbox((5, 7, 3), (50, 41, 20))):
    for kw in (dict(), dict(agglomerate=True), dict(agglomerate=True, timestamp=T_MERGE + 1),
               dict(agglomerate=True, timestamp=0), dict(stop_layer=2),
               dict(stop_layer=2, timestamp=T_SPLIT + 1), dict(stop_layer=1)):
      got, ref = pv.download(box, **kw), jv.download(box, **kw)
      assert got.dtype == ref.dtype and got.shape == ref.shape
      assert np.array_equal(got, ref), kw
  if layers["backend"] == "http":
    assert layers["servers"]["port"].requests == layers["servers"]["jax"].requests
  with pytest.raises(ValueError, match="stop_layer"):
    pv.download(pv.bounds, stop_layer=3)
  plain = Volume(f"file://{layers['root']['port']}")
  for kw in (dict(agglomerate=True), dict(stop_layer=2)):
    with pytest.raises(ValueError, match="graphene"):
      plain.download(plain.bounds, **kw)


# -- meshes ---------------------------------------------------------------------


def test_graphene_mesh_forge_matches_reference(layers):
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_graphene_meshing_tasks(layers["jax"], timestamp=T_MERGE + 1))
  LocalTaskQueue().insert(tc.create_graphene_meshing_tasks(layers["port"], timestamp=T_MERGE + 1))
  got = _same(layers["root"]["jax"], layers["root"]["port"], "mesh_graphene")
  frags = [k for k in got if k.endswith(".frags")]
  assert len(frags) == 2  # the default task: twice the graph chunk
  assert _files(layers["root"]["port"])["info"] == _files(layers["root"]["jax"])["info"]
  from igneous_tpu_torch.mesh_io import FragMap

  labels = {l for k in frags for l in FragMap.frombytes(got[k]).keys()}
  assert labels and min(labels) >= 2**40


def test_mesh_forge_of_a_graphene_layer_matches_reference(layers):
  """``mesh forge graphene://...`` makes MeshTasks that mesh the L2 ids."""
  args = ["mesh", "forge", "--shape", "32,48,24", "--sharded"]
  res = CliRunner().invoke(jax_cli, [*args[:2], layers["jax"], *args[2:]])
  assert res.exit_code == 0, res.output
  assert cli_main([*args[:2], layers["port"], *args[2:]]) == 0
  _same(layers["root"]["jax"], layers["root"]["port"], "mesh_mip_0")


# -- skeletons ------------------------------------------------------------------


SKELETONS = {
  "roots": dict(),
  "fix_autapses": dict(fix_autapses=True),
  "fix_autapses_timestamp": dict(fix_autapses=True, timestamp=T_MERGE + 1),
  "timestamp_before_merge": dict(timestamp=T_MERGE - 1),
  "fix_autapses_sharded": dict(fix_autapses=True, sharded=True),
}


@pytest.mark.parametrize("case", sorted(SKELETONS))
def test_graphene_skeletons_match_reference(case, layers):
  kw = {**FORGE, **SKELETONS[case]}
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_skeletonizing_tasks(layers["jax"], shape=(32, 24, 24), **kw))
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(layers["port"], shape=(32, 24, 24), **kw))
  if not kw.get("sharded"):
    JaxQueue(parallel=1, progress=False).insert(
      jax_tc.create_unsharded_skeleton_merge_tasks(layers["jax"], **MERGE))
    LocalTaskQueue().insert(tc.create_unsharded_skeleton_merge_tasks(layers["port"], **MERGE))
  got = _same(layers["root"]["jax"], layers["root"]["port"], "skeletons")
  assert any(k.endswith((".sk.gz", ".frags")) for k in got)
  assert any(k.endswith(".spatial.gz") for k in got)


def test_graphene_skeletons_from_a_root_ids_layer_match_reference(layers, tmp_path):
  """``root_ids_cloudpath``: the labels of a materialized root layer (each
  package's own), with the autapse graph of the chunk graph."""
  roots = {}
  for who, mod in (("jax", jax_graphene), ("port", graphene)):
    roots[who] = f"file://{tmp_path}/roots_{who}"
    ids = JaxVolume(layers["jax"]).download(Bbox((0, 0, 0), (64, 48, 24)), agglomerate=True)
    JaxVolume.from_numpy(ids, roots[who], resolution=(8, 8, 40), chunk_size=(16, 16, 12),
                         layer_type="segmentation")
  kw = dict(FORGE, shape=(32, 24, 24), fix_autapses=True)
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_skeletonizing_tasks(
    layers["jax"], root_ids_cloudpath=roots["jax"], **kw))
  args = ["skeleton", "forge", layers["port"], "--shape", "32,24,24", "--dust-threshold", "40",
          "--scale", "4", "--const", "80", "--fix-autapses", "--root-ids", roots["port"]]
  assert cli_main(args) == 0
  _same(layers["root"]["jax"], layers["root"]["port"], "skeletons")


def test_graphene_skeleton_payload_runs_in_the_port(layers):
  from igneous_tpu.queues.registry import serialize as jax_serialize
  from igneous_tpu_torch.queues import deserialize

  kw = dict(FORGE, shape=(32, 24, 24), fix_autapses=True, timestamp=T_SPLIT + 1)
  jax_tasks = list(jax_tc.create_skeletonizing_tasks(layers["jax"], **kw))
  list(tc.create_skeletonizing_tasks(layers["port"], **kw))
  JaxQueue(parallel=1, progress=False).insert(jax_tasks)
  for t in jax_tasks:
    task = deserialize(jax_serialize(t).replace(layers["jax"], layers["port"]))
    assert isinstance(task, SkeletonTask) and task.fix_autapses
    task.execute()
  _same(layers["root"]["jax"], layers["root"]["port"], "skeletons")


def test_cli_graphene_skeleton_forge_matches_reference(layers):
  args = ["skeleton", "forge", "--shape", "32,24,24", "--dust-threshold", "40",
          "--scale", "4", "--const", "80", "--fix-autapses", "--timestamp", "15"]
  res = CliRunner().invoke(jax_cli, [*args[:2], layers["jax"], *args[2:]])
  assert res.exit_code == 0, res.output
  assert cli_main([*args[:2], layers["port"], *args[2:]]) == 0
  _same(layers["root"]["jax"], layers["root"]["port"], "skeletons")


def test_cross_section_repair_on_a_graphene_layer_matches_reference(layers):
  """The contact repair downloads agglomerated ids (the skeletons are keyed
  by roots)."""
  kw = dict(FORGE, shape=(32, 24, 24), cross_sectional_area=True, timestamp=T_MERGE + 1)
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_skeletonizing_tasks(layers["jax"], **kw))
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(layers["port"], **kw))
  _same(layers["root"]["jax"], layers["root"]["port"], "skeletons")


# -- transfers and the census ---------------------------------------------------


TRANSFERS = {
  "agglomerate": dict(agglomerate=True, shape=(32, 32, 24), num_mips=0),
  "agglomerate_2_mips": dict(agglomerate=True, timestamp=T_MERGE + 1, shape=(64, 48, 24),
                             num_mips=2, chunk_size=(16, 16, 12)),
  "l2": dict(stop_layer=2, shape=(32, 48, 24), num_mips=1, chunk_size=(16, 16, 12)),
  "supervoxels": dict(stop_layer=1, shape=(32, 48, 24), num_mips=0),
}


@pytest.mark.parametrize("case", sorted(TRANSFERS))
def test_agglomerated_transfers_match_reference(case, layers, tmp_path, monkeypatch):
  """The port maps ids in each task's compute stage, in task order (its
  pipeline too); the JAX package maps them in the download stage, whose
  prefetch threads may take tasks out of order, and L2 ids are numbered on
  first sight: the JAX side runs its serial loop."""
  kw = TRANSFERS[case]
  dest = {who: tmp_path / f"dest_{who}" for who in ("jax", "port")}
  monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_transfer_tasks(layers["jax"], f"file://{dest['jax']}", **kw))
  monkeypatch.delenv("IGNEOUS_PIPELINE")
  LocalTaskQueue().insert(tc.create_transfer_tasks(layers["port"], f"file://{dest['port']}", **kw))
  got = _same(dest["jax"], dest["port"])
  assert json.loads(got["info"])["data_type"] == "uint64"
  img = Volume(f"file://{dest['port']}").download(Bbox((0, 0, 0), (64, 48, 24)))
  assert np.unique(img).max() >= (2**48 if kw.get("agglomerate") else 2**32)


def test_sharded_agglomerated_transfer_and_downsample_match_reference(layers, tmp_path):
  dest = {who: tmp_path / f"sh_{who}" for who in ("jax", "port")}
  kw = dict(agglomerate=True, timestamp=T_SPLIT + 1, chunk_size=(16, 16, 12), memory_target=2**17)
  jax_tc_tasks = list(jax_tc.create_image_shard_transfer_tasks(
    layers["jax"], f"file://{dest['jax']}", **kw))
  JaxQueue(parallel=1, progress=False).insert(jax_tc_tasks)
  LocalTaskQueue().insert(tc.create_image_shard_transfer_tasks(
    layers["port"], f"file://{dest['port']}", **kw))
  got = _same(dest["jax"], dest["port"])
  assert sum(k.endswith(".shard") for k in got) >= 2
  # the watershed layer is uint64: its own scales take root ids
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_image_shard_downsample_tasks(
    layers["jax"], agglomerate=True, timestamp=T_MERGE + 1, num_mips=1, memory_target=2**17))
  LocalTaskQueue().insert(tc.create_image_shard_downsample_tasks(
    layers["port"], agglomerate=True, timestamp=T_MERGE + 1, num_mips=1, memory_target=2**17))
  _same(layers["root"]["jax"], layers["root"]["port"])


def test_agglomerated_census_matches_reference(layers):
  for ts in (None, T_MERGE - 1):
    JaxQueue(parallel=1, progress=False).insert(jax_tc.create_voxel_counting_tasks(
      layers["jax"], shape=(32, 24, 24), agglomerate=True, timestamp=ts))
    LocalTaskQueue().insert(tc.create_voxel_counting_tasks(
      layers["port"], shape=(32, 24, 24), agglomerate=True, timestamp=ts))
    got = _same(layers["root"]["jax"], layers["root"]["port"], "stats")
    assert len(got) == 4
    counts = json.loads(__import__("gzip").decompress(next(iter(got.values()))))
    assert any(int(k) >= 2**48 for k in counts)


# -- invalid combinations --------------------------------------------------------


def _plain(tmp_path):
  data = np.zeros((16, 16, 16), np.uint32)
  data[2:14, 2:14, 2:14] = 5
  path = tmp_path / "plain"
  JaxVolume.from_numpy(data, f"file://{path}", layer_type="segmentation")
  return f"file://{path}", data


def test_invalid_graphene_combinations_raise_as_the_reference(tmp_path):
  plain, data = _plain(tmp_path)
  dest = f"file://{tmp_path}/dst"
  calls = [
    (lambda m: m.create_transfer_tasks(plain, dest, shape=(16, 16, 16), agglomerate=True), "graphene"),
    (lambda m: m.create_transfer_tasks(plain, dest, shape=(16, 16, 16), timestamp=1.0), "timestamp"),
    (lambda m: m.create_image_shard_transfer_tasks(plain, dest, stop_layer=2), "graphene"),
    (lambda m: m.create_image_shard_downsample_tasks(plain, agglomerate=True), "graphene"),
    (lambda m: m.create_voxel_counting_tasks(plain, agglomerate=True), "graphene"),
    (lambda m: m.create_skeletonizing_tasks(plain, fix_autapses=True), "graphene"),
  ]
  for call, match in calls:
    for mod in (jax_tc, tc):
      with pytest.raises(ValueError, match=match):
        call(mod)
  assert not (tmp_path / "dst").exists()
  with pytest.raises(ValueError, match="timestamp"):
    TransferTask(plain, dest, mip=0, shape=(8, 8, 8), offset=(0, 0, 0), timestamp=123.0)
  # the task itself: fix_autapses without graphene raises before writing
  task = SkeletonTask(plain, shape=(16, 16, 16), offset=(0, 0, 0), fix_autapses=True,
                      skel_dir="skel")
  with pytest.raises(ValueError, match="fix_autapses requires a graphene"):
    task.execute()
  # a graphene layer: a bad stop layer; a uint32 watershed layer's ids go to
  # a uint64 destination, and an existing narrower one is refused
  for mod, who in ((jax_graphene, "jax"), (graphene, "port")):
    inner = f"file://{tmp_path}/ws_{who}"
    JaxVolume.from_numpy(data, inner, resolution=(16, 16, 16), chunk_size=(16, 16, 16),
                         layer_type="segmentation")
    mod.use_local_chunkgraph(f"graphene://{inner}", mod.LocalChunkGraph(chunk_size=(16, 16, 16)))
  queues = {"jax": JaxQueue(parallel=1, progress=False), "port": LocalTaskQueue()}
  for who, mod in (("jax", jax_tc), ("port", tc)):
    gpath = f"graphene://file://{tmp_path}/ws_{who}"
    with pytest.raises(ValueError, match="stop_layer"):
      mod.create_transfer_tasks(gpath, dest, shape=(16, 16, 16), stop_layer=3)
    with pytest.raises(ValueError, match="uint64"):
      mod.create_image_shard_downsample_tasks(gpath, agglomerate=True)
    queues[who].insert(mod.create_transfer_tasks(
      gpath, f"file://{tmp_path}/roots_{who}", shape=(16, 16, 16), agglomerate=True))
    assert JaxVolume(f"file://{tmp_path}/roots_{who}").meta.data_type == "uint64"
  _same(tmp_path / "roots_jax", tmp_path / "roots_port")
  narrow = f"file://{tmp_path}/narrow"
  JaxVolume.from_numpy(data, narrow, layer_type="segmentation")
  for who, mod in (("jax", jax_tc), ("port", tc)):
    with pytest.raises(ValueError, match="uint64"):
      mod.create_transfer_tasks(f"graphene://file://{tmp_path}/ws_{who}", narrow,
                                shape=(16, 16, 16), agglomerate=True)


def test_unregistered_graphene_path_raises_as_the_reference(tmp_path):
  plain, _ = _plain(tmp_path)
  for vol in (JaxVolume, Volume):
    with pytest.raises(NotImplementedError, match="chunk-graph client"):
      vol(f"graphene://{plain}")
