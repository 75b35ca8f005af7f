"""The port's mesh forge and merge against the JAX package.

The same layer goes through both packages' create_meshing_tasks ->
LocalTaskQueue -> MeshTask, then create_mesh_manifest_tasks ->
MeshManifestPrefixTask: every file under the mesh directory (the mesh
info, the fragments (gzip by default; gzip-1, gzip-9, zstd and none in
their own tests), the .spatial files, the <label>:0 manifests) and the
layer's info must be byte-identical. Also: payloads the JAX package
serialized run in the port, the command lines agree, ``fill_holes`` and
``dust_global`` (after a voxel-count census) write the same fragments,
sharded ``.frags``, draco fragments, ``merge --nlod`` and graphene layers
(meshed at L2 granularity) write the same files.
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


def hollow(dtype=np.uint64, seed=0) -> np.ndarray:
  """``voronoi(dtype, seed)`` with a background ball (radius 2) at every
  seed that lies inside its own cell, an enclosed cavity; every third
  ball joined to the membrane along +x by a one-voxel channel, which
  level 1 leaves open and level 3 closes. Plus specks with ids of their
  own across the task boundary x = 32: each of the 45-voxel ones (18
  voxels left of it, 27 right) reaches 40 only in the whole layer; the
  27-voxel ones stay below it."""
  out = voronoi(dtype, seed)
  seeds = np.random.default_rng(seed).integers(0, SHAPE, (len(IDS), 3))
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
  for i, c in enumerate(seeds):
    ball = ((grid - c) ** 2).sum(-1) <= 4
    label = out[tuple(c)]
    if not label or not (out[ball] == label).all() or (c < 3).any() or (c >= np.asarray(SHAPE) - 3).any():
      continue
    out[ball] = 0
    if i % 3 == 0:
      x = c[0]
      while x < SHAPE[0] and out[x, c[1], c[2]] in (0, label):
        if out[x, c[1], c[2]] == 0 and x > c[0] + 2:
          break
        out[x, c[1], c[2]] = 0
        x += 1
  specks = [((30, 35), (4, 7), (4, 7), 2**63 + 99), ((30, 35), (30, 33), (16, 19), 555),
            ((31, 34), (16, 19), (10, 13), 2**62 + 3), ((10, 13), (20, 23), (18, 21), 777)]
  for (x0, x1), (y0, y1), (z0, z1), label in specks:
    out[x0:x1, y0:y1, z0:z1] = label if dtype == np.uint64 else label % 2**32
  return np.asfortranarray(out)


def _census(jax_path: str, port_path: str, cli: bool = False) -> None:
  """The voxel-count census of both layers, each by its own package."""
  if cli:
    runner = CliRunner()
    for args in (["count", jax_path, "--shape", "32,32,32"], ["sum", jax_path]):
      res = runner.invoke(jax_cli, ["image", "voxels", *args])
      assert res.exit_code == 0, res.output
    assert cli_main(["image", "voxels", "count", port_path, "--shape", "32,32,32"]) == 0
    assert cli_main(["image", "voxels", "sum", port_path]) == 0
    return
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_voxel_counting_tasks(jax_path, shape=TASK))
  jax_tc.accumulate_voxel_counts(jax_path)
  LocalTaskQueue().insert(tc.create_voxel_counting_tasks(port_path, shape=TASK))
  tc.accumulate_voxel_counts(port_path)


MORPH_CASES = {
  "fill_holes_1": dict(fill_holes=1),
  "fill_holes_3": dict(fill_holes=3),
  "dust_global": dict(dust_global=True, dust_threshold=40),
  "dust_global_fill_holes_3_uint32": dict(dust_global=True, dust_threshold=40, fill_holes=3),
}


@pytest.mark.parametrize("case", sorted(MORPH_CASES))
def test_fill_holes_and_dust_global_match_reference(case, tmp_path):
  kw = MORPH_CASES[case]
  dtype = np.uint32 if case.endswith("uint32") else np.uint64
  paths = _layers(tmp_path, hollow(dtype))
  jax_path, port_path = (f"file://{paths[w]}" for w in ("jax", "port"))
  if kw.get("dust_global"):
    _census(jax_path, port_path)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_meshing_tasks(jax_path, shape=TASK, **kw))
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_mesh_manifest_tasks(jax_path))
  LocalTaskQueue().insert(tc.create_meshing_tasks(port_path, shape=TASK, **kw))
  LocalTaskQueue().insert(tc.create_mesh_manifest_tasks(port_path))
  ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
  assert len(got) > 4
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  if kw.get("dust_global"):
    # the 45-voxel specks across x = 32 are meshed, the 27-voxel one not
    meshed = {k.split("/")[-1].split(":")[0] for k in got if k.count(":") == 2}
    assert {str(2**63 + 99 if dtype == np.uint64 else (2**63 + 99) % 2**32),
            "555"} <= meshed
    assert "777" not in meshed


@pytest.mark.parametrize("case", ["fill_holes_1", "fill_holes_3_dust_global"])
def test_cli_fill_holes_and_dust_global_match_reference(case, tmp_path):
  paths = _layers(tmp_path, hollow(seed=1))
  jax_path, port_path = (f"file://{paths[w]}" for w in ("jax", "port"))
  args = ["--shape", "32,32,32", "--simplify-factor", "20"]
  if case == "fill_holes_1":
    args += ["--fill-holes", "1"]
  else:
    _census(jax_path, port_path, cli=True)
    args += ["--fill-holes", "3", "--dust", "40", "--dust-global"]
  runner = CliRunner()
  res = runner.invoke(jax_cli, ["mesh", "forge", jax_path, *args])
  assert res.exit_code == 0, res.output
  assert cli_main(["mesh", "forge", port_path, *args]) == 0
  ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
  assert len(got) > 4 and got == ref


def test_dust_global_without_a_census_raises_as_the_reference(tmp_path):
  paths = _layers(tmp_path, hollow())
  kw = dict(shape=TASK, dust_global=True, dust_threshold=40)
  with pytest.raises(ValueError, match="voxel-count census"):
    JaxQueue(parallel=1, progress=False).insert(
      jax_tc.create_meshing_tasks(f"file://{paths['jax']}", **kw))
  with pytest.raises(ValueError, match="voxel-count census"):
    LocalTaskQueue().insert(tc.create_meshing_tasks(f"file://{paths['port']}", **kw))


# fragment compression: each method of the storage's table (and the
# command line's "none"), fragment names and bytes as the JAX package writes
COMPRESSIONS = {"gzip-1": ".gz", "gzip-9": ".gz", "zstd": ".zstd", "none": ""}


def _fragments(files):
  return {k: v for k, v in files.items() if k.count(":") == 2}


def _check_compressed(paths, method):
  ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
  frags = _fragments(got)
  assert len(frags) > 4 and sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  assert any(".spatial" in k for k in got)
  ext = COMPRESSIONS[method]
  assert all(k.endswith(ext) for k in frags)
  if not ext:
    assert not any(k.endswith((".gz", ".zstd")) for k in frags)
  # the fragments read back through the port's storage, whatever the method
  mdir = Volume(f"file://{paths['port']}").info["mesh"]
  cf = CloudFiles(f"file://{paths['port']}")
  for key in frags:
    name = key.split("/")[-1]
    name = name[: len(name) - len(ext)] if ext else name
    assert len(Mesh.from_precomputed(cf.get(f"{mdir}/{name}")).faces) > 0


@pytest.mark.parametrize("method", sorted(COMPRESSIONS))
def test_compressed_fragments_match_reference(method, tmp_path):
  """create_meshing_tasks -> LocalTaskQueue -> MeshTask, then mesh merge,
  with each compression: fragments, .spatial files and manifests byte for
  byte the JAX package's ("none" is None to the JAX package's factory,
  whose command line maps it so)."""
  data = voronoi(np.uint32, seed=2)
  paths = _layers(tmp_path, data)
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_meshing_tasks(
    f"file://{paths['jax']}", shape=TASK, compress=None if method == "none" else method))
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_mesh_manifest_tasks(f"file://{paths['jax']}"))
  LocalTaskQueue().insert(
    tc.create_meshing_tasks(f"file://{paths['port']}", shape=TASK, compress=method))
  LocalTaskQueue().insert(tc.create_mesh_manifest_tasks(f"file://{paths['port']}"))
  _check_compressed(paths, method)


@pytest.mark.parametrize("method", sorted(COMPRESSIONS))
def test_cli_compressed_fragments_match_reference(method, tmp_path):
  paths = _layers(tmp_path, voronoi(seed=3))
  args = ["--shape", "32,32,32", "--compress", method]
  runner = CliRunner()
  res = runner.invoke(jax_cli, ["mesh", "forge", f"file://{paths['jax']}", *args])
  assert res.exit_code == 0, res.output
  res = runner.invoke(jax_cli, ["mesh", "merge", f"file://{paths['jax']}"])
  assert res.exit_code == 0, res.output
  assert cli_main(["mesh", "forge", str(paths["port"]), *args]) == 0
  assert cli_main(["mesh", "merge", str(paths["port"])]) == 0
  _check_compressed(paths, method)


@pytest.mark.parametrize("method", ["br", "gzip-0", "gzip-10", "lz4"])
def test_unknown_fragment_compression_raises_before_writing(method, tmp_path):
  path = tmp_path / "layer"
  Volume.from_numpy(voronoi(), f"file://{path}", resolution=(8, 8, 40),
                    chunk_size=(16, 16, 16))
  before = _files(path)
  with pytest.raises(ValueError, match="Unsupported compression"):
    tc.create_meshing_tasks(f"file://{path}", shape=TASK, compress=method)
  with pytest.raises(ValueError, match="Unsupported compression"):
    MeshTask(shape=TASK, offset=(0, 0, 0), layer_path=f"file://{path}", compress=method)
  assert _files(path) == before


LIFTED = {
  "sharded": dict(sharded=True),
  "draco": dict(encoding="draco"),
}


@pytest.mark.parametrize("option", sorted(LIFTED) + ["graphene"])
def test_once_refused_options_match_reference(option, tmp_path):
  """Sharded output, draco fragments and graphene layers, refused here
  until the port ran them, write the JAX package's bytes (through the
  factory, and the command line for ``--sharded`` and graphene)."""
  if option in LIFTED:
    paths = _forge_both(tmp_path, voronoi(), **LIFTED[option])
    ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
    assert len(got) > 4 and got == ref
    if option == "sharded":
      assert sum(k.endswith(".frags") for k in got) == 4
      cli = _layers(tmp_path / "cli", voronoi())
      assert cli_main(["mesh", "forge", str(cli["port"]), "--sharded",
                       "--shape", "32,32,32"]) == 0
      assert _mesh_files(cli["port"]) == {k: v for k, v in got.items() if ":0" not in k}
    return
  # a graphene layer meshes its L2 ids (each package with its own chunk
  # graph: one edge, chunks of 32x16x16)
  from igneous_tpu import graphene as jax_graphene
  from igneous_tpu_torch import graphene

  # (ids below 2^63: the JAX package's root ids are the ids plus 2^48)
  data = voronoi(np.uint32)
  paths = _layers(tmp_path, data)
  cli = _layers(tmp_path / "cli", data)
  ids = [int(v) for v in np.unique(data) if v][:2]
  layers = {}
  try:
    for who, mod in (("jax", jax_graphene), ("port", graphene)):
      for p in (paths[who], cli[who]):
        layers[p] = f"graphene://file://{p}"
        mod.use_local_chunkgraph(layers[p], mod.LocalChunkGraph([ids], (32, 16, 16)))
    JaxQueue(parallel=1, progress=False).insert(
      jax_tc.create_meshing_tasks(layers[paths["jax"]], shape=TASK))
    LocalTaskQueue().insert(tc.create_meshing_tasks(layers[paths["port"]], shape=TASK))
    ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
    assert len(got) > 4 and got == ref
    assert min(int(k.split("/")[-1].split(":")[0]) for k in got if ":0:" in k) >= 2**40
    res = CliRunner().invoke(jax_cli, ["mesh", "forge", layers[cli["jax"]], "--shape", "32,32,32"])
    assert res.exit_code == 0, res.output
    assert cli_main(["mesh", "forge", layers[cli["port"]], "--shape", "32,32,32"]) == 0
    assert _mesh_files(cli["port"]) == _mesh_files(cli["jax"])
  finally:
    for mod in (jax_graphene, graphene):
      mod._GRAPHENE_CLIENT_FACTORY = None
      mod._LOCAL_GRAPHS.clear()


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
  """``mesh merge --nlod 1``, refused here until the port ran multires
  meshes, writes the JAX command's unsharded multires files."""
  paths = _layers(tmp_path, voronoi())
  for args in (["forge", "--shape", "32,32,32"],
               ["merge", "--nlod", "1", "--min-chunk-size", "4,4,4"]):
    res = CliRunner().invoke(jax_cli, ["mesh", args[0], str(paths["jax"]), *args[1:]])
    assert res.exit_code == 0, res.output
    assert cli_main(["mesh", args[0], str(paths["port"]), *args[1:]]) == 0
  ref, got = _mesh_files(paths["jax"]), _mesh_files(paths["port"])
  assert sum(k.endswith(".index") for k in got) > 5 and got == ref
  assert _files(paths["port"])["info"] == _files(paths["jax"])["info"]


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
