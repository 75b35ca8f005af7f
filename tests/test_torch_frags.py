"""The port's sharded forges, sharded skeleton merges and spatial-index
databases against the JAX package.

The same seeded layers go through both packages: ``mesh forge --sharded``
(Precomputed and draco fragments) and ``skeleton forge --sharded`` write
one ``.frags`` container a task, byte for byte the JAX package's, whose
entries are the legacy forge's fragments ungzipped; ``skeleton
merge-sharded`` (by the spatial index or its sqlite db, gzip or raw data,
one or several shards) and ``skeleton xfer --sharded`` write the same
shard files and infos; ``mesh|skeleton spatial-index db`` build databases
whose queries answer alike (the db's own bytes are sqlite's). Every label
the index names reads back from the shards. Exact everywhere.
"""

import gzip
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.spatial_index import SpatialIndex as JaxSpatialIndex
from igneous_tpu_torch import CloudFiles, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.lib import Bbox
from igneous_tpu_torch.mesh_io import FragMap, decode_mesh
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.sharding import ShardReader, ShardingSpecification
from igneous_tpu_torch.skeleton_io import Skeleton
from igneous_tpu_torch.spatial_index import SpatialIndex

from test_torch_integrity import flush_local, layer_tree
from test_torch_mesh_tasks import TASK, voronoi
from test_torch_mesh_tasks import _layers as _mesh_layers
from test_torch_skeleton_tasks import FORGE, MERGE, tubes
from test_torch_skeleton_tasks import _layers as _skel_layers

SKEL_TASK = (32, 24, 24)  # 2 x 2 x 1 tasks of the 64x48x24 tubes


def _cpu(mp):
  mp.setenv(device.ENV, "cpu")
  mp.setenv("IGNEOUS_EDT_BACKEND", "native")
  mp.delenv("IGNEOUS_MESH_EMIT", raising=False)
  mp.delenv("IGNEOUS_SCRATCH_COMPRESS", raising=False)
  device.reset_device()


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  _cpu(monkeypatch)
  yield
  device.reset_device()


def _run_both(paths, jax_tasks, port_tasks, **kw):
  JaxQueue(parallel=1, progress=False).insert(jax_tasks(f"file://{paths['jax']}", **kw))
  LocalTaskQueue().insert(port_tasks(f"file://{paths['port']}", **kw))


def _copy(paths, tmp_path):
  out = {}
  for who, src in paths.items():
    out[who] = tmp_path / who
    shutil.copytree(src, out[who])
  return out


def _same(paths):
  ref, got = layer_tree(paths["jax"]), layer_tree(paths["port"])
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  return got


# -- meshes --------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["precomputed", "draco"])
def test_sharded_mesh_forge_matches_reference(encoding, tmp_path):
  data = voronoi()
  sharded = _mesh_layers(tmp_path / "sharded", data)
  _run_both(sharded, jax_tc.create_meshing_tasks, tc.create_meshing_tasks,
            shape=TASK, sharded=True, encoding=encoding)
  got = _same(sharded)
  frags = sorted(k for k in got if k.endswith(".frags"))
  assert len(frags) == 4 and not any(k.endswith(".gz") and ":" in k for k in got)
  # each container holds exactly the legacy forge's fragments, ungzipped
  legacy = _mesh_layers(tmp_path / "legacy", data)
  LocalTaskQueue().insert(tc.create_meshing_tasks(
    f"file://{legacy['port']}", shape=TASK, encoding=encoding))
  mdir = "mesh_mip_0_err_40"
  labels = set()
  for key in frags:
    fm = FragMap(got[key])
    bbox = Bbox.from_filename(key.split("/")[-1])
    core = Bbox(bbox.minpt // (8, 8, 40), bbox.maxpt // (8, 8, 40))
    for label in fm.keys().tolist():
      legacy_frag = legacy["port"] / mdir / f"{label}:0:{core.to_filename()}.gz"
      assert fm.get(label) == gzip.decompress(legacy_frag.read_bytes())
      assert len(decode_mesh(fm.get(label), encoding).faces)
      labels.add(label)
  assert labels == set(np.unique(data).tolist()) - {0}


# -- skeletons -----------------------------------------------------------------


@pytest.fixture(scope="module")
def skel_forged(tmp_path_factory):
  """Both packages' sharded and unsharded (merged) skeleton forges of the
  same tube layer."""
  root = tmp_path_factory.mktemp("skel")
  data = tubes()
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    _cpu(mp)
    for sharded in (False, True):
      paths = _skel_layers(root / ("sharded" if sharded else "legacy"), data)
      _run_both(paths, jax_tc.create_skeletonizing_tasks, tc.create_skeletonizing_tasks,
                shape=SKEL_TASK, sharded=sharded, **FORGE)
      if not sharded:
        _run_both(paths, jax_tc.create_unsharded_skeleton_merge_tasks,
                  tc.create_unsharded_skeleton_merge_tasks, **MERGE)
      out[sharded] = paths
    flush_local()
  device.reset_device()
  return out


def _read_skeleton_shards(root, sdir, labels):
  cf = CloudFiles(f"file://{root}")
  info = cf.get_json(f"{sdir}/info")
  reader = ShardReader(cf, ShardingSpecification.from_dict(info["sharding"]), prefix=sdir)
  out = {}
  for label in sorted(labels):
    data = reader.get_chunk(label)
    assert data is not None, label
    out[label] = Skeleton.from_precomputed(data, vertex_attributes=info["vertex_attributes"])
  return out


def test_sharded_skeleton_forge_matches_reference(skel_forged):
  got = _same(skel_forged[True])
  frags = [k for k in got if k.endswith(".frags")]
  assert len(frags) == 4 and not any(k.endswith(".sk.gz") for k in got)
  # the containers hold the unsharded forge's fragments, ungzipped
  legacy = skel_forged[False]["port"]
  for key in frags:
    fm = FragMap(got[key])
    bbox = Bbox.from_filename(key.split("/")[-1])
    core = Bbox(bbox.minpt // (8, 8, 40), bbox.maxpt // (8, 8, 40))
    for label in fm.keys().tolist():
      sk = legacy / key.split("/")[0] / f"{label}:{core.to_filename()}.sk.gz"
      assert fm.get(label) == gzip.decompress(sk.read_bytes())


MERGE_CASES = {
  "defaults": dict(),
  "one_label_a_shard": dict(max_labels_per_shard=1),
  "raw_data": dict(data_encoding="raw", max_labels_per_shard=3),
  "sqlite_db": dict(spatial_index_db=True, max_labels_per_shard=4),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_sharded_skeleton_merge_matches_reference(case, skel_forged, tmp_path):
  kw = {**MERGE, **MERGE_CASES[case]}
  paths = _copy(skel_forged[True], tmp_path)
  if kw.pop("spatial_index_db", False):
    # the port's db, read by both factories
    db = str(tmp_path / "index.db")
    assert cli_main(["skeleton", "spatial-index", "db", f"file://{paths['port']}", db]) == 0
    kw["spatial_index_db"] = db
  _run_both(paths, jax_tc.create_sharded_skeleton_merge_tasks,
            tc.create_sharded_skeleton_merge_tasks, **kw)
  got = _same(paths)
  shards = [k for k in got if k.endswith(".shard")]
  assert len(shards) >= (2 if "max_labels_per_shard" in kw else 1)
  sdir = shards[0].split("/")[0]
  labels = SpatialIndex(CloudFiles(f"file://{paths['port']}"), sdir).query()
  skels = _read_skeleton_shards(paths["port"], sdir, labels)
  assert len(skels) == len(labels) > 5


def test_skeleton_merge_sharded_cli_matches_reference(skel_forged, tmp_path, capsys):
  paths = _copy(skel_forged[True], tmp_path)
  args = ["--dust-threshold", "50", "--tick-threshold", "100",
          "--max-labels-per-shard", "4", "--minishard-index-bytes", "40000"]
  res = CliRunner().invoke(jax_cli, ["skeleton", "merge-sharded", f"file://{paths['jax']}", *args])
  assert res.exit_code == 0, res.output
  q = f"fq://{tmp_path}/q"
  assert cli_main(["skeleton", "merge-sharded", f"file://{paths['port']}", *args,
                   "--queue", q]) == 0
  assert cli_main(["execute", q, "-x", "-q"]) == 0
  assert sum(k.endswith(".shard") for k in _same(paths)) >= 2


def test_skeleton_xfer_sharded_matches_reference(skel_forged, tmp_path, capsys):
  paths = _copy(skel_forged[False], tmp_path)
  dests = {who: tmp_path / f"dest_{who}" for who in paths}
  for who in paths:
    shutil.copytree(paths[who], dests[who], ignore=shutil.ignore_patterns("skel*"))
  res = CliRunner().invoke(jax_cli, ["skeleton", "xfer", f"file://{paths['jax']}",
                                     f"file://{dests['jax']}", "--sharded"])
  assert res.exit_code == 0, res.output
  assert cli_main(["skeleton", "xfer", f"file://{paths['port']}",
                   f"file://{dests['port']}", "--sharded"]) == 0
  got = _same(dests)
  sdir = "skeletons_mip_0_sharded"
  labels = [int(k.split("/")[-1]) for k in CloudFiles(f"file://{paths['port']}").list(
    "skeletons_mip_0/") if k.split("/")[-1].isdigit()]
  assert f"{sdir}/info" in got and len(labels) > 5
  cf = CloudFiles(f"file://{paths['port']}")
  for label, skel in _read_skeleton_shards(dests["port"], sdir, labels).items():
    assert skel.to_precomputed() == cf.get(f"skeletons_mip_0/{label}")


# -- spatial-index databases ---------------------------------------------------


@pytest.mark.parametrize("kind", ["mesh", "skeleton"])
def test_spatial_index_db_queries_match_reference(kind, skel_forged, tmp_path, capsys):
  if kind == "mesh":
    paths = _mesh_layers(tmp_path / "mesh", voronoi())
    LocalTaskQueue().insert(tc.create_meshing_tasks(f"file://{paths['port']}", shape=TASK))
    index_dir = "mesh_mip_0_err_40"
    path = paths["port"]
  else:
    path = skel_forged[True]["port"]
    index_dir = "skeletons_mip_0"
  dbs = {who: str(tmp_path / f"{who}.db") for who in ("jax", "port")}
  res = CliRunner().invoke(jax_cli, [kind, "spatial-index", "db", f"file://{path}", dbs["jax"]])
  assert res.exit_code == 0, res.output
  assert cli_main([kind, "spatial-index", "db", f"file://{path}", dbs["port"],
                   "--progress"]) == 0
  out = capsys.readouterr()
  assert out.out.replace(dbs["port"], "DB") == res.output.replace(dbs["jax"], "DB")
  assert "spatial index cells" in out.err
  rng = np.random.default_rng(1)
  boxes = [None] + [Bbox(lo, lo + rng.integers(8, 200, 3)) for lo in rng.integers(0, 400, (8, 3))]
  answers = []
  for box in boxes:
    got = SpatialIndex.query_sqlite(dbs["port"], box)
    assert got == JaxSpatialIndex.query_sqlite(dbs["jax"], box)
    assert got == JaxSpatialIndex.query_sqlite(dbs["port"], box)
    answers.append(len(got))
  assert answers[0] > 5 and len(set(answers)) > 1
  all_labels = SpatialIndex(CloudFiles(f"file://{path}"), index_dir).query()
  assert SpatialIndex.query_sqlite(dbs["port"]) == all_labels
  assert any(label >= 2**63 for label in SpatialIndex.query_sqlite(dbs["port"]))


def test_spatial_index_db_missing_cells(tmp_path, capsys):
  paths = _mesh_layers(tmp_path, voronoi())
  LocalTaskQueue().insert(tc.create_meshing_tasks(f"file://{paths['port']}", shape=TASK))
  cf = CloudFiles(f"file://{paths['port']}")
  key = next(k for k in cf.list("mesh_mip_0_err_40/") if k.endswith(".spatial"))
  cf.put(key, b"{}", compress="gzip")  # an empty cell is skipped in both
  locations = SpatialIndex(cf, "mesh_mip_0_err_40").file_locations_per_label()
  ref = JaxSpatialIndex(cf, "mesh_mip_0_err_40").file_locations_per_label()
  assert locations == ref and key not in {k for v in locations.values() for k in v}
  n = SpatialIndex(cf, "mesh_mip_0_err_40").to_sqlite(str(tmp_path / "a.db"))
  assert n == JaxSpatialIndex(cf, "mesh_mip_0_err_40").to_sqlite(str(tmp_path / "b.db"))
  # an unreadable cell raises unless allow_missing, in both
  real = cf.get_json
  cf.get_json = lambda k: None if k == key else real(k)
  for index in (SpatialIndex, JaxSpatialIndex):
    with pytest.raises(FileNotFoundError, match="allow_missing"):
      index(cf, "mesh_mip_0_err_40").to_sqlite(str(tmp_path / "c.db"))
  assert SpatialIndex(cf, "mesh_mip_0_err_40").to_sqlite(
    str(tmp_path / "d.db"), allow_missing=True) == n
