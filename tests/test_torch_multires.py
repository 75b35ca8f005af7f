"""The port's draco codec, multires meshes and their merges against the
JAX package.

Draco streams of the same mesh are byte-identical and decode alike;
``process_mesh`` writes the same manifest and fragment bytes; and every
route to multires meshes writes the same files in both packages from the
same seeded layer (48x40x24, 2 x 2 x 1 tasks of 32^3, ids at and above
2^63): ``mesh merge --nlod 1`` (unsharded multires), ``mesh forge
--sharded`` then ``mesh merge-sharded``, and ``mesh xfer --sharded`` into
another layer, through both command lines, the factories and an fq://
queue. Every shard reads back through the port's ``ShardReader``: each
manifest parses, its fragment sizes sum to the bytes before it, and every
draco fragment decodes to vertices inside the stored lattice. Exact
everywhere.
"""

import json
import pathlib
import shutil
import struct

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import draco as jax_draco
from igneous_tpu import mesh_io as jax_mesh_io
from igneous_tpu import mesh_multires as jax_multires
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu_torch import CloudFiles, device, draco, mesh_io, mesh_multires
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.sharding import ShardReader, ShardingSpecification

from test_torch_frags import _copy
from test_torch_integrity import flush_local, layer_tree as _files
from test_torch_mesh_tasks import TASK, _layers, voronoi


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.delenv("IGNEOUS_MESH_EMIT", raising=False)
  device.reset_device()
  yield
  device.reset_device()


def uv_sphere(n=24, r=37.5, center=(101.0, 57.25, 203.5), seed=0):
  """A closed UV sphere of float32 vertices, jittered by a seed."""
  rng = np.random.default_rng(seed)
  th = np.linspace(0, np.pi, n)[1:-1]
  ph = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
  t, p = np.meshgrid(th, ph, indexing="ij")
  ring = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1)
  v = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]])
  v = v * r * (1 + 0.05 * rng.random((len(v), 1))) + center
  rows, cols = len(th), len(ph)
  idx = lambda i, j: 1 + i * cols + (j % cols)
  faces = [(0, idx(0, j), idx(0, j + 1)) for j in range(cols)]
  for i in range(rows - 1):
    for j in range(cols):
      faces += [(idx(i, j), idx(i + 1, j), idx(i + 1, j + 1)),
                (idx(i, j), idx(i + 1, j + 1), idx(i, j + 1))]
  last = len(v) - 1
  faces += [(last, idx(rows - 1, j + 1), idx(rows - 1, j)) for j in range(cols)]
  return v.astype(np.float32), np.asarray(faces, np.uint32)


def parse_manifest(data: bytes):
  """(chunk_shape, grid_origin, num_lods, [(positions, sizes)] per lod)."""
  chunk_shape = np.frombuffer(data, "<f4", 3, 0)
  grid_origin = np.frombuffer(data, "<f4", 3, 12)
  (num_lods,) = struct.unpack_from("<I", data, 24)
  pos = 28 + 4 * num_lods + 12 * num_lods
  nfrags = np.frombuffer(data, "<u4", num_lods, pos)
  pos += 4 * num_lods
  lods = []
  for n in nfrags:
    positions = np.frombuffer(data, "<u4", int(n) * 3, pos).reshape(-1, 3)
    pos += 12 * int(n)
    lods.append((positions, np.frombuffer(data, "<u4", int(n), pos)))
    pos += 4 * int(n)
  assert pos == len(data)
  return chunk_shape, grid_origin, num_lods, lods


DRACO_CASES = {
  "sphere_default": (uv_sphere(), {}),
  "fragment_settings": (uv_sphere(n=10), mesh_multires.fragment_draco_settings(16)),
  "u16_indices": (uv_sphere(n=40, seed=3), dict(quantization_bits=11)),
  "varint_indices": (uv_sphere(n=190, seed=4), dict(quantization_bits=20)),
  "origin_and_range": (uv_sphere(n=8, seed=5), dict(
    quantization_bits=16, quantization_origin=(60.0, 10.0, 160.0),
    quantization_range=90.0)),
  "empty": ((np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32)), {}),
}


@pytest.mark.parametrize("case", sorted(DRACO_CASES))
def test_draco_streams_match_reference(case):
  (v, f), kw = DRACO_CASES[case]
  data = draco.encode(v, f, **kw)
  assert data == jax_draco.encode(v, f, **kw)
  got, ref = draco.decode(data), jax_draco.decode(data)
  for name in ("vertices", "faces", "quantized"):
    assert np.array_equal(getattr(got, name), getattr(ref, name)), name
  assert got.quantization_bits == ref.quantization_bits
  # the mesh_io hook: the same bytes, and back to the same mesh
  hooked = mesh_io.encode_mesh(mesh_io.Mesh(v, f), "draco", **kw)
  assert hooked == data
  got, ref = mesh_io.decode_mesh(hooked, "draco"), jax_mesh_io.decode_mesh(hooked, "draco")
  assert np.array_equal(got.vertices, ref.vertices) and np.array_equal(got.faces, ref.faces)


def test_registered_draco_codec_is_used():
  calls = []
  mesh_io.register_draco_codec(
    lambda m, **kw: calls.append("encode") or b"stub",
    lambda data: calls.append("decode") or mesh_io.Mesh(np.zeros((0, 3)), np.zeros((0, 3))),
  )
  try:
    v, f = uv_sphere(n=6)
    assert mesh_io.encode_mesh(mesh_io.Mesh(v, f), "draco") == b"stub"
    assert len(mesh_io.decode_mesh(b"stub", "draco")) == 0
  finally:
    mesh_io._DRACO_CODEC = None
  assert calls == ["encode", "decode"]
  assert mesh_io.encode_mesh(mesh_io.Mesh(v, f), "draco") == jax_draco.encode(v, f)


PROCESS_CASES = {
  "lods_1": dict(num_lods=1),
  "lods_2": dict(num_lods=2),
  "lods_3": dict(num_lods=3),
  "lods_3_min_chunk": dict(num_lods=3, min_chunk_size=(40.0, 40.0, 40.0)),
  "chunk_size": dict(num_lods=2, chunk_size=(16.0, 24.0, 30.0)),
  "vqb_10": dict(num_lods=2, quantization_bits=10),
  "precomputed": dict(num_lods=2, encoding="precomputed"),
}


@pytest.mark.parametrize("case", sorted(PROCESS_CASES))
def test_process_mesh_matches_reference(case):
  kw = PROCESS_CASES[case]
  v, f = uv_sphere(n=30, seed=7)
  got = mesh_multires.process_mesh(mesh_io.Mesh(v, f), **kw)
  ref = jax_multires.process_mesh(jax_mesh_io.Mesh(v, f), **kw)
  assert got == ref
  manifest, frags = got
  _, _, num_lods, lods = parse_manifest(manifest)
  assert sum(int(s) for _, sizes in lods for s in sizes) == len(frags)
  assert mesh_multires.multires_info(10, mip=2) == jax_multires.multires_info(10, mip=2)


def _read_shards(root: pathlib.Path, mesh_dir: str):
  """Every label of the sharded multires dir: {label: (manifest, frags)},
  checked for a parsing manifest whose fragment sizes sum to the bytes
  that precede it, and for draco fragments inside the stored lattice."""
  cf = CloudFiles(f"file://{root}")
  info = cf.get_json(f"{mesh_dir}/info")
  spec = ShardingSpecification.from_dict(info["sharding"])
  reader = ShardReader(cf, spec, prefix=mesh_dir)
  lattice = 2 ** info["vertex_quantization_bits"]
  out = {}
  shards = sorted(k for k in cf.list(f"{mesh_dir}/") if k.endswith(".shard"))
  for key in shards:
    shard_no = int(key.split("/")[-1].split(".")[0], 16)
    raw = cf.get(key)
    for label in reader.list_labels(shard_no).tolist():
      manifest = reader.get_chunk(label)
      _, _, num_lods, lods = parse_manifest(manifest)
      total = sum(int(s) for _, sizes in lods for s in sizes)
      start = raw.find(manifest)
      frags = raw[start - total : start]
      pos = 0
      for _, sizes in lods:
        for size in sizes.tolist():
          m = mesh_io.decode_mesh(frags[pos : pos + size], "draco")
          pos += size
          assert len(m.faces) and m.vertices.min() >= 0 and m.vertices.max() <= lattice
      out[label] = (num_lods, manifest, frags)
  return shards, out


@pytest.fixture(scope="module")
def forged(tmp_path_factory):
  """Both packages' legacy and sharded forges of the same layer."""
  root = tmp_path_factory.mktemp("forged")
  data = voronoi()
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv(device.ENV, "cpu")
    mp.delenv("IGNEOUS_MESH_EMIT", raising=False)
    device.reset_device()
    for sharded in (False, True):
      paths = _layers(root / ("sharded" if sharded else "legacy"), data)
      JaxQueue(parallel=1, progress=False).insert(jax_tc.create_meshing_tasks(
        f"file://{paths['jax']}", shape=TASK, sharded=sharded))
      LocalTaskQueue().insert(tc.create_meshing_tasks(
        f"file://{paths['port']}", shape=TASK, sharded=sharded))
      out[sharded] = paths
  flush_local()
  device.reset_device()
  return out


def _both_clis(args_of, paths, capsys):
  """Run one command line in both packages; returns both outputs."""
  res = CliRunner().invoke(jax_cli, args_of(paths["jax"]))
  assert res.exit_code == 0, res.output
  assert cli_main(args_of(paths["port"])) == 0
  return res.output, capsys.readouterr().out


def test_unsharded_multires_merge_matches_reference(forged, tmp_path, capsys):
  paths = _copy(forged[False], tmp_path)
  # the default finest cell (256^3 voxels) would cap these small meshes
  # at one LOD
  _both_clis(lambda p: ["mesh", "merge", f"file://{p}", "--nlod", "1",
                        "--magnitude", "1", "--min-chunk-size", "4,4,4"], paths, capsys)
  ref, got = _files(paths["jax"]), _files(paths["port"])
  multires = sorted(k for k in got if k.startswith("mesh_mip_0_err_40_multires/"))
  assert len(multires) > 10 and sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  cf = CloudFiles(f"file://{paths['port']}")
  lod_counts = set()
  for key in (k for k in multires if k.endswith(".index")):
    _, _, num_lods, lods = parse_manifest(cf.get(key))
    frags = cf.get(key[: -len(".index")])
    assert sum(int(size) for _, sizes in lods for size in sizes) == len(frags)
    lod_counts.add(num_lods)
  # labels smaller than two finest cells keep one LOD
  assert lod_counts == {1, 2}


def test_sharded_multires_merge_matches_reference(forged, tmp_path, capsys):
  paths = _copy(forged[True], tmp_path)
  _both_clis(lambda p: ["mesh", "merge-sharded", f"file://{p}", "--nlod", "1",
                        "--max-labels-per-shard", "4", "--min-chunk-size", "4,4,4"],
            paths, capsys)
  ref, got = _files(paths["jax"]), _files(paths["port"])
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  shards, labels = _read_shards(paths["port"], "mesh_mip_0_err_40")
  assert len(shards) >= 2 and len(labels) == len(set(voronoi().ravel()) - {0})
  assert {n for n, _, _ in labels.values()} == {1, 2}


def test_sharded_merge_through_a_queue_and_threads_matches_reference(forged, tmp_path):
  """The factory's tasks through fq:// (the port's worker drains it) with
  parallel=3 and a draco level, against the JAX package run locally."""
  paths = _copy(forged[True], tmp_path)
  kw = dict(num_lods=3, min_chunk_size=(8, 8, 8), max_labels_per_shard=3,
            draco_compression_level=1)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_sharded_multires_mesh_tasks(f"file://{paths['jax']}", **kw))
  q = f"fq://{tmp_path}/q"
  assert cli_main(["mesh", "merge-sharded", f"file://{paths['port']}", "--queue", q,
                   "--num-lods", "3", "--min-chunk-size", "8,8,8",
                   "--max-labels-per-shard", "3", "--compress-level", "1"]) == 0
  assert cli_main(["execute", q, "-x", "-q"]) == 0
  ref, got = _files(paths["jax"]), _files(paths["port"])
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  threaded = _copy(forged[True], tmp_path / "threaded")
  LocalTaskQueue().insert(tc.create_sharded_multires_mesh_tasks(
    f"file://{threaded['port']}", parallel=3, **kw))
  assert _files(threaded["port"]) == got


def test_mesh_xfer_sharded_matches_reference(forged, tmp_path, capsys):
  paths = _copy(forged[False], tmp_path)
  dests = {who: tmp_path / f"dest_{who}" for who in paths}
  for who in paths:
    shutil.copytree(paths[who], dests[who], ignore=shutil.ignore_patterns("mesh*"))
  res = CliRunner().invoke(jax_cli, ["mesh", "xfer", f"file://{paths['jax']}",
                                     f"file://{dests['jax']}", "--sharded", "--nlod", "1"])
  assert res.exit_code == 0, res.output
  assert cli_main(["mesh", "xfer", f"file://{paths['port']}", f"file://{dests['port']}",
                   "--sharded", "--nlod", "1"]) == 0
  ref, got = _files(dests["jax"]), _files(dests["port"])
  assert sorted(got) == sorted(ref) and any(k.endswith(".shard") for k in got)
  assert [k for k in ref if got[k] != ref[k]] == []
  _read_shards(dests["port"], "mesh_mip_0_err_40_multires")
  # the source layer is left as it was
  assert _files(paths["port"]) == _files(forged[False]["port"])


def test_sharded_from_unsharded_in_place_matches_reference(forged, tmp_path):
  paths = _copy(forged[False], tmp_path)
  kw = dict(mesh_dir="mr", num_lods=2, vertex_quantization_bits=10,
            max_labels_per_shard=5)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_sharded_multires_mesh_from_unsharded_tasks(f"file://{paths['jax']}", **kw))
  LocalTaskQueue().insert(tc.create_sharded_multires_mesh_from_unsharded_tasks(
    f"file://{paths['port']}", **kw))
  ref, got = _files(paths["jax"]), _files(paths["port"])
  assert sorted(got) == sorted(ref) and "mr/info" in got
  assert [k for k in ref if got[k] != ref[k]] == []
  _read_shards(paths["port"], "mr")


def test_multires_info_on_a_bucket_without_volume_info(tmp_path):
  got = tc.configure_multires_info(f"file://{tmp_path}/port", "m", sharding={"x": 1})
  ref = jax_tc.configure_multires_info(f"file://{tmp_path}/jax", "m", sharding={"x": 1})
  assert got == ref
  for name in ("m/info", "info"):
    assert (tmp_path / "port" / name).exists() == (name == "m/info")
    assert (tmp_path / "jax" / name).exists() == (name == "m/info")
  assert (tmp_path / "port/m/info").read_bytes() == (tmp_path / "jax/m/info").read_bytes()


def test_unsharded_multires_payload_runs_in_the_port(forged, tmp_path):
  """A multires merge payload serialized by the JAX package runs in the
  port (and the port's in the JAX package), with the same files."""
  from igneous_tpu.queues.registry import deserialize as jax_deserialize
  from igneous_tpu.queues.registry import serialize as jax_serialize
  from igneous_tpu_torch.queues import deserialize, serialize

  paths = _copy(forged[False], tmp_path)
  jax_tasks = list(jax_tc.create_unsharded_multires_mesh_tasks(
    f"file://{paths['port']}", magnitude=1))
  port_tasks = list(tc.create_unsharded_multires_mesh_tasks(
    f"file://{paths['jax']}", magnitude=1))

  def wire(payload, path):
    doc = json.loads(payload.replace(str(path), "LAYER"))
    return doc["class"], doc["params"]

  assert [wire(jax_serialize(t), paths["port"]) for t in jax_tasks] == [
    wire(serialize(t), paths["jax"]) for t in port_tasks]
  for t in jax_tasks:
    deserialize(jax_serialize(t)).execute()
  for t in port_tasks:
    jax_deserialize(serialize(t)).execute()
  ref, got = _files(paths["jax"]), _files(paths["port"])
  assert [k for k in ref if got.get(k) != ref[k]] == [] and sorted(got) == sorted(ref)
