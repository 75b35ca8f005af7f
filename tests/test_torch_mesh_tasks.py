"""The port's mesh forge and merge against the JAX package.

The same layer goes through both packages' create_meshing_tasks ->
LocalTaskQueue -> MeshTask, then create_mesh_manifest_tasks ->
MeshManifestPrefixTask: every file under the mesh directory (the mesh
info, the gzip fragments, the .spatial files, the <label>:0 manifests) and
the layer's info must be byte-identical. Also: payloads the JAX package
serialized run in the port, the command lines agree, and the options the
port does not run yet raise before anything is written.
"""

import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import CloudFiles, Volume, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.lib import Bbox
from igneous_tpu_torch.mesh_io import Mesh
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.spatial_index import SpatialIndex
from igneous_tpu_torch.tasks import MeshTask

SHAPE = (48, 40, 24)  # (x, y, z); 2 x 2 x 1 tasks of 32^3
TASK = (32, 32, 32)
IDS = np.array(
  [2**33 + 1, 2**33 + 77, 2**40, 2**63, 2**63 + 5, 2**64 - 2, 9, 123, 4567, 31337,
   2**32 - 1, 600, 2**50 + 3, 17, 2**63 + 2**40],
  dtype=np.uint64,
)


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.delenv("IGNEOUS_MESH_EMIT", raising=False)
  device.reset_device()
  yield
  device.reset_device()


def voronoi(dtype=np.uint64, seed=0) -> np.ndarray:
  """(x, y, z) labels: a Voronoi partition of 15 seeds, with a 1-voxel
  gap of background wherever two cells touch along x."""
  rng = np.random.default_rng(seed)
  seeds = rng.integers(0, SHAPE, (len(IDS), 3))
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
  cell = ((grid[..., None, :] - seeds) ** 2).sum(-1).argmin(-1)
  ids = IDS if dtype == np.uint64 else (IDS % np.uint64(2**32)).astype(np.uint32)
  out = ids[cell]
  out[1:][cell[1:] != cell[:-1]] = 0
  return np.asfortranarray(out)


def _files(root: pathlib.Path):
  """Every file of a layer but its provenance (which records a date)."""
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file() and p.name != "provenance"
  }


def _mesh_files(root: pathlib.Path):
  """The files under the mesh directory (all but the info and the chunks)."""
  return {k: v for k, v in _files(root).items() if "/" in k and not k.startswith("8_8_40/")}


def _layers(tmp_path, data, chunk=(16, 16, 16)):
  paths = {}
  for who in ("jax", "port"):
    paths[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{paths[who]}", resolution=(8, 8, 40),
                         chunk_size=chunk, layer_type="segmentation")
  return paths


def _forge_both(tmp_path, data, **kw):
  paths = _layers(tmp_path, data)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_meshing_tasks(f"file://{paths['jax']}", shape=TASK, **kw))
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_mesh_manifest_tasks(f"file://{paths['jax']}"))
  LocalTaskQueue().insert(tc.create_meshing_tasks(f"file://{paths['port']}", shape=TASK, **kw))
  LocalTaskQueue().insert(tc.create_mesh_manifest_tasks(f"file://{paths['port']}"))
  return paths


CASES = {
  "uint64_defaults": (np.uint64, {}),
  "uint32_defaults": (np.uint32, {}),
  "object_ids": (np.uint64, dict(object_ids=[int(IDS[3]), int(IDS[7]), 2**62])),
  "exclude_object_ids": (np.uint64, dict(exclude_object_ids=[int(IDS[0]), int(IDS[4])])),
  "remap_table": (np.uint64, dict(remap_table={
    int(IDS[0]): int(IDS[0]), int(IDS[1]): int(IDS[0]), int(IDS[4]): 5, 0: 99})),
  "dust_threshold": (np.uint64, dict(dust_threshold=1500)),
  "open_edge": (np.uint64, dict(closed_dataset_edges=False)),
  "tetrahedra": (np.uint64, dict(mesher="tetrahedra")),
  "skip_simplify": (np.uint64, dict(simplification=False)),
  "simplify_parallel_2": (np.uint64, dict(parallel=2)),
  "no_spatial_index_no_gzip": (np.uint32, dict(spatial_index=False, compress=None,
                                               mesh_dir="meshes")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forge_and_merge_match_reference(case, tmp_path):
  dtype, kw = CASES[case]
  paths = _forge_both(tmp_path, voronoi(dtype), **kw)
  ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
  assert len(got) > 4
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  assert _files(paths["port"])["info"] == _files(paths["jax"])["info"]


def test_forged_meshes_cover_their_labels(tmp_path):
  """Every label has a manifest listing fragments that exist; the spatial
  index names every meshed label."""
  data = voronoi()
  paths = _layers(tmp_path, data)
  path = f"file://{paths['port']}"
  LocalTaskQueue().insert(tc.create_meshing_tasks(path, shape=TASK))
  LocalTaskQueue().insert(tc.create_mesh_manifest_tasks(path))
  vol = Volume(path)
  mdir = vol.info["mesh"]
  cf = CloudFiles(path)
  labels = {int(v) for v in np.unique(data) if v}
  frags = [k.split("/")[-1] for k in cf.list(f"{mdir}/") if k.count(":") == 2]
  listed = []
  for label in labels:
    manifest = cf.get_json(f"{mdir}/{label}:0")
    listed += manifest["fragments"]
    for name in manifest["fragments"]:
      mesh = Mesh.from_precomputed(cf.get(f"{mdir}/{name}"))
      assert len(mesh.faces) > 0
  assert sorted(listed) == sorted(frags)
  assert SpatialIndex(cf, mdir).query() == labels
  assert SpatialIndex(cf, mdir).query(Bbox((0, 0, 0), (1, 1, 1))) <= labels


def test_reference_payload_runs_in_the_port(tmp_path):
  paths = _layers(tmp_path, voronoi())
  for who in ("jax", "port"):
    jax_tc.create_meshing_tasks(f"file://{paths[who]}", shape=TASK)  # writes the infos
  tasks = list(jax_tc.create_meshing_tasks(f"file://{paths['jax']}", shape=TASK))
  JaxQueue(parallel=1, progress=False).insert(tasks)
  for task in tasks:
    payload = jax_serialize(task).replace(str(paths["jax"]), str(paths["port"]))
    ported = deserialize(payload)
    assert type(ported) is MeshTask
    ported.execute()
  assert _mesh_files(paths["port"]) == _mesh_files(paths["jax"])


def test_cli_forge_and_merge_match_reference(tmp_path):
  paths = _layers(tmp_path, voronoi(np.uint32, seed=1))
  args = ["--shape", "32,32,32", "--dust", "40", "--labels",
          ",".join(str(int(v) % 2**32) for v in IDS[:9]), "--simplify-factor", "20"]
  runner = CliRunner()
  res = runner.invoke(jax_cli, ["mesh", "forge", f"file://{paths['jax']}", *args])
  assert res.exit_code == 0, res.output
  res = runner.invoke(jax_cli, ["mesh", "merge", f"file://{paths['jax']}", "--magnitude", "3"])
  assert res.exit_code == 0, res.output
  assert cli_main(["mesh", "forge", str(paths["port"]), *args]) == 0
  assert cli_main(["mesh", "merge", str(paths["port"]), "--magnitude", "3"]) == 0
  assert _mesh_files(paths["port"]) == _mesh_files(paths["jax"])


REFUSED = {
  "sharded": dict(sharded=True),
  "dust_global": dict(dust_global=True, dust_threshold=10),
  "fill_holes": dict(fill_holes=1),
  "draco": dict(encoding="draco"),
}


@pytest.mark.parametrize("option", sorted(REFUSED) + ["graphene"])
def test_unported_options_raise_before_writing(option, tmp_path):
  path = tmp_path / "layer"
  Volume.from_numpy(voronoi(), f"file://{path}", resolution=(8, 8, 40),
                    chunk_size=(16, 16, 16))
  before = _files(path)
  kw = REFUSED.get(option, {})
  layer = f"graphene://file://{path}" if option == "graphene" else f"file://{path}"
  with pytest.raises(NotImplementedError):
    tc.create_meshing_tasks(layer, shape=TASK, **kw)
  with pytest.raises(NotImplementedError):
    MeshTask(shape=TASK, offset=(0, 0, 0), layer_path=layer, **kw)
  cli = {"sharded": ["--sharded"], "dust_global": ["--dust-global"],
         "fill_holes": ["--fill-holes", "1"]}.get(option)
  if cli or option == "graphene":
    with pytest.raises(NotImplementedError):
      cli_main(["mesh", "forge", layer, *(cli or [])])
  assert _files(path) == before


def test_download_at_and_past_the_bounds_as_the_reference(tmp_path):
  # MeshTask clips its grown cutout to the bounds before downloading; a
  # box past them raises in both packages
  data = voronoi()
  paths = _layers(tmp_path, data)
  ref = JaxVolume(f"file://{paths['jax']}")
  got = Volume(f"file://{paths['port']}")
  edge = ((20, 30, 20), data.shape)
  assert np.array_equal(got.download(Bbox(*edge)), ref.download(JaxBbox(*edge)))
  past = ((20, 30, 20), tuple(s + 1 for s in data.shape))
  with pytest.raises(Exception, match="not contained"):
    ref.download(JaxBbox(*past))
  with pytest.raises(Exception, match="not contained"):
    got.download(Bbox(*past))


def test_merge_refuses_multires_before_writing(tmp_path):
  path = tmp_path / "layer"
  Volume.from_numpy(voronoi(), f"file://{path}", resolution=(8, 8, 40),
                    chunk_size=(16, 16, 16))
  assert cli_main(["mesh", "forge", str(path), "--shape", "32,32,32"]) == 0
  before = _files(path)
  with pytest.raises(NotImplementedError, match="nlod"):
    cli_main(["mesh", "merge", str(path), "--nlod", "1"])
  assert _files(path) == before


def test_mesh_task_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
  import torch

  path = tmp_path / "layer"
  Volume.from_numpy(voronoi(), f"file://{path}", resolution=(8, 8, 40),
                    chunk_size=(16, 16, 16))
  tasks = list(tc.create_meshing_tasks(f"file://{path}", shape=TASK))
  before = _files(path)
  monkeypatch.delenv(device.ENV)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tasks[0].execute()
  assert _files(path) == before
