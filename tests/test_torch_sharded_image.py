"""Sharded image scales in the port, against the JAX package.

``create_image_shard_transfer_tasks`` and
``create_image_shard_downsample_tasks`` with ``ImageShardTransferTask``
and ``ImageShardDownsampleTask``: the same seeded layer through both
packages, and every file held byte for byte (shard files, ``info``, the
integrity manifests compared as records without ``ts``), the task
payloads and the provenance (without its date): uint8 raw, png and jpeg,
uint64 raw, compressed_segmentation and compresso, a mip-1 source, an
existing destination, cutout bounds, a translation, odd extents (601x421),
the ``num_mips`` clamp, average and mode pooling. Each package reads and
downsamples the other's sharded layer; ``LocalTaskQueue`` pipelined
equals serial; a ``--batch 4`` worker runs sharded members solo; the
command lines write the same layers.

The repair of ``Volume`` (each test below under "Volume" fails on the
tree before sharded scales were ported): a sharded scale reads through
its shards as the JAX package reads it, a direct write to one raises the
JAX package's ``VolumeException``, and ``exists``, ``delete`` and
``non_aligned_writes`` behave as the JAX package's.
"""

import json
import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.volume import VolumeException as JaxVolumeException
from igneous_tpu_torch import Bbox, Volume, chunk_cache, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.meta import PrecomputedMetadata
from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import ImageShardDownsampleTask, ImageShardTransferTask
from igneous_tpu_torch.volume import EmptyVolumeError, VolumeException

from test_torch_integrity import flush_local, layer_tree

ODD = (601, 421, 20)  # 10 x 7 x 2 chunks of 64 x 64 x 16, ragged in x and y
CHUNK = (64, 64, 16)


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  for name in ("IGNEOUS_PIPELINE", "IGNEOUS_INTEGRITY", "IGNEOUS_CHUNK_CACHE"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  flush_local()
  yield
  flush_local()
  chunk_cache.clear()
  device.reset_device()


def image(shape, dtype=np.uint8, seed=0):
  """A smooth ramp plus noise, as EM imagery."""
  rng = np.random.default_rng(seed)
  ramp = np.add.outer(np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])),
                      3 * np.arange(shape[2]))
  return np.asfortranarray(((ramp + rng.integers(0, 20, shape)) % 255).astype(dtype))


def segmentation(shape, seed=0):
  """uint64 labels in 3x3x2 cells: ids above 2^32, one at or above 2^63, and
  2-2 ties in the 2x2 windows."""
  rng = np.random.default_rng(seed)
  cells = rng.integers(0, 6, (shape[0] // 3 + 1, shape[1] // 3 + 1, shape[2] // 2 + 1))
  cells = np.kron(cells, np.ones((3, 3, 2), np.int64))[: shape[0], : shape[1], : shape[2]]
  ids = np.array([0, 2**40, 2**40 + 2**33 + 7, 2**63 + 5, 2**33, 77], np.uint64)
  return np.asfortranarray(ids[cells])


def _prov(root: pathlib.Path, name: str):
  prov = json.loads((root / name / "provenance").read_text())
  for entry in prov["processing"]:
    entry.pop("date")
  return json.loads(json.dumps(prov).replace(str(root), "ROOT"))


def _params(tasks, root):
  return [json.loads(json.dumps(t.payload()["params"]).replace(str(root), "ROOT"))
          for t in tasks]


def _jax_queue():
  return JaxQueue(parallel=1, progress=False)


def _both(tmp_path, data, src_kw=None, prepare=None):
  """tmp/jax/src and tmp/port/src, each written by the JAX package, and
  ``prepare(side, root)`` run on each (e.g. an existing destination)."""
  roots = {}
  for side in ("jax", "port"):
    roots[side] = tmp_path / side
    JaxVolume.from_numpy(data, f"file://{roots[side] / 'src'}", resolution=(8, 8, 40),
                         **dict(dict(chunk_size=CHUNK), **(src_kw or {})))
    if prepare is not None:
      prepare(side, roots[side])
  return roots


def _run(side, make, root):
  tasks = list(make(jax_tc if side == "jax" else tc, root))
  (_jax_queue() if side == "jax" else LocalTaskQueue(parallel=1)).insert(tasks)
  return tasks


def _assert_same(roots, name, tasks=None):
  assert layer_tree(roots["port"] / name) == layer_tree(roots["jax"] / name)
  assert _prov(roots["port"], name) == _prov(roots["jax"], name)
  if tasks is not None:
    assert _params(tasks["port"], roots["port"]) == _params(tasks["jax"], roots["jax"])
  assert any(p.suffix == ".shard" for p in (roots["port"] / name).rglob("*"))


# ---------------------------------------------------------------------------
# the transfer into a sharded scale

def _mip1_source(side, root):
  _jax_queue().insert(jax_tc.create_downsampling_tasks(f"file://{root / 'src'}", num_mips=1))


def _existing_dest(side, root):
  """A destination already there, unsharded, with other voxels (and the
  source's chunking: a shard grid must line up with the task grid)."""
  JaxVolume.from_numpy(image((256, 128, 16), seed=5), f"file://{root / 'dest'}",
                       resolution=(8, 8, 40), chunk_size=CHUNK)


XFER_CASES = {
  # name: (data, src kw, prepare, factory kw)
  "uint8_raw": (lambda: image(ODD), {}, None, dict(memory_target=int(2e5))),
  "uint8_png": (lambda: image(ODD), {}, None,
                dict(encoding="png", memory_target=int(1e6), encoding_level=3)),
  "uint8_jpeg": (lambda: image(ODD), {}, None,
                 dict(encoding="jpeg", chunk_size=(128, 128, 16))),
  "uint8_compress_none": (lambda: image(ODD), {}, None,
                          dict(compress=False, minishard_index_encoding="raw")),
  "uint64_raw": (lambda: segmentation((301, 211, 16), seed=1), {}, None,
                 dict(memory_target=int(4e5))),
  "uint64_cseg": (lambda: segmentation((301, 211, 16), seed=2), {}, None,
                  dict(encoding="compressed_segmentation", memory_target=int(1e6))),
  "uint64_compresso": (lambda: segmentation((301, 211, 16), seed=3), {}, None,
                       dict(encoding="compresso")),
  "mip1_source": (lambda: image(ODD, seed=4), {}, _mip1_source,
                  dict(mip=1, memory_target=int(2e5))),
  "existing_dest": (lambda: image((256, 128, 16), seed=6), {}, _existing_dest,
                    dict(memory_target=int(3e5))),
  "cutout_bounds": (lambda: image(ODD, seed=7), {}, None,
                    dict(bounds=JaxBbox((128, 64, 0), (448, 320, 20)), cutout=True,
                         memory_target=int(2e5), clean_info=True)),
  "translate": (lambda: segmentation((192, 128, 16), seed=8), {}, None,
                dict(translate=(64, 128, 16), memory_target=int(3e5))),
  "offset_source": (lambda: image((200, 150, 16), seed=9), dict(voxel_offset=(3, 5, 7)), None,
                    dict(memory_target=int(1e5))),
}


@pytest.mark.parametrize("case", sorted(XFER_CASES))
def test_shard_transfer_matches_reference(tmp_path, case):
  make_data, src_kw, prepare, kw = XFER_CASES[case]
  roots = _both(tmp_path, make_data(), src_kw, prepare)
  tasks = {}
  for side, root in roots.items():
    bkw = dict(kw)
    if "bounds" in bkw and side == "port":
      bkw["bounds"] = Bbox(bkw["bounds"].minpt, bkw["bounds"].maxpt)
    tasks[side] = _run(side, lambda lib, r: lib.create_image_shard_transfer_tasks(
      f"file://{r / 'src'}", f"file://{r / 'dest'}", **bkw), root)
  assert len(tasks["port"]) >= 1
  _assert_same(roots, "dest", tasks)
  # the port reads its shards back: the source's voxels
  mip = kw.get("mip", 0)
  src, dest = Volume(f"file://{roots['port'] / 'src'}", mip=mip), \
    Volume(f"file://{roots['port'] / 'dest'}", mip=mip)
  if case not in ("uint8_jpeg", "existing_dest", "cutout_bounds") and "translate" not in kw:
    np.testing.assert_array_equal(dest.download(dest.bounds), src.download(src.bounds))


def test_shard_transfer_grid_has_several_shards(tmp_path):
  """The cases above write many shard files at mip 0: the task grid is
  shard aligned and each task writes whole shards."""
  roots = _both(tmp_path, image(ODD))
  tasks = _run("port", lambda lib, r: lib.create_image_shard_transfer_tasks(
    f"file://{r / 'src'}", f"file://{r / 'dest'}", memory_target=int(2e5)), roots["port"])
  spec = Volume(f"file://{roots['port'] / 'dest'}").meta.sharding(0)
  shards = sorted(p.name for p in (roots["port"] / "dest" / "8_8_40").iterdir())
  assert len(tasks) >= 4 and len(shards) >= len(tasks)
  assert spec["hash"] == "identity" and spec["shard_bits"] >= 4


# ---------------------------------------------------------------------------
# the sharded downsample

DS_CASES = {
  # name: (data, src kw, factory kw, shard the source first)
  "uint8_average": (lambda: image(ODD), {}, dict(num_mips=3, memory_target=int(2e6)), False),
  "uint64_mode": (lambda: segmentation((301, 211, 16), seed=1), {},
                  dict(num_mips=2, memory_target=int(4e6)), False),
  "uint64_cseg_mode": (lambda: segmentation((192, 128, 16), seed=2),
                       dict(encoding="compressed_segmentation"),
                       dict(num_mips=2, memory_target=int(2e7)), False),
  # 7^7 chunks of stride: log2(7^7) / log2(7) floors to 6, one mip short
  "num_mips_clamp": (lambda: image(ODD, seed=3), {}, dict(num_mips=7, factor=(7, 7, 1)),
                     False),
  "jpeg_top_png": (lambda: image((256, 256, 16), seed=4), dict(encoding="jpeg"),
                   dict(num_mips=2, memory_target=int(1e7)), False),
  "sharded_source": (lambda: image(ODD, seed=5), {}, dict(num_mips=2, memory_target=int(1e6)),
                     True),
  "bounds_volumetric": (lambda: image((256, 256, 32), seed=6), {},
                        dict(num_mips=2, factor=(2, 2, 2), memory_target=int(5e6),
                             bounds=JaxBbox((0, 0, 0), (128, 256, 32))), False),
  "encoding_level": (lambda: image((256, 192, 16), seed=7), {},
                     dict(num_mips=1, encoding="png", encoding_level=4,
                          chunk_size=(32, 32, 16)), False),
}


@pytest.mark.parametrize("case", sorted(DS_CASES))
def test_shard_downsample_matches_reference(tmp_path, case):
  make_data, src_kw, kw, shard_first = DS_CASES[case]
  roots = _both(tmp_path, make_data(), src_kw)
  layer = "src"
  tasks = {}
  for side, root in roots.items():
    if shard_first:
      _run(side, lambda lib, r: lib.create_image_shard_transfer_tasks(
        f"file://{r / 'src'}", f"file://{r / 'sharded'}", memory_target=int(2e5)), root)
      layer = "sharded"
    bkw = dict(kw)
    if "bounds" in bkw and side == "port":
      bkw["bounds"] = Bbox(bkw["bounds"].minpt, bkw["bounds"].maxpt)
    tasks[side] = _run(side, lambda lib, r: lib.create_image_shard_downsample_tasks(
      f"file://{r / layer}", **bkw), root)
  _assert_same(roots, layer, tasks)
  info = Volume(f"file://{roots['port'] / layer}").info
  if case == "num_mips_clamp":
    assert tasks["port"][0].num_mips == 6
  if case == "jpeg_top_png":
    assert info["scales"][-1]["encoding"] == "png" and info["scales"][-1]["png_level"] == 9


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_downsamples_the_others_sharded_layer(tmp_path, writer):
  """A sharded mip 0 written by one package, downsampled (sharded) by both:
  the same files."""
  roots = _both(tmp_path, segmentation((301, 211, 16), seed=9))
  for root in roots.values():
    _run(writer, lambda lib, r: lib.create_image_shard_transfer_tasks(
      f"file://{r / 'src'}", f"file://{r / 'sharded'}", memory_target=int(4e5)), root)
  for side, root in roots.items():
    _run(side, lambda lib, r: lib.create_image_shard_downsample_tasks(
      f"file://{r / 'sharded'}", num_mips=2, memory_target=int(4e6)), root)
  _assert_same(roots, "sharded")


def test_unsharded_transfer_and_downsample_read_a_sharded_source(tmp_path):
  """create_transfer_tasks and create_downsampling_tasks from a sharded
  scale: the JAX package's files."""
  roots = _both(tmp_path, image(ODD, seed=10))
  for side, root in roots.items():
    _run(side, lambda lib, r: lib.create_image_shard_transfer_tasks(
      f"file://{r / 'src'}", f"file://{r / 'sharded'}", memory_target=int(2e5)), root)
    _run(side, lambda lib, r: lib.create_transfer_tasks(
      f"file://{r / 'sharded'}", f"file://{r / 'copy'}", chunk_size=(32, 32, 16),
      num_mips=2, shape=(128, 128, 16)), root)
  assert layer_tree(roots["port"] / "copy") == layer_tree(roots["jax"] / "copy")
  assert _prov(roots["port"], "sharded") == _prov(roots["jax"], "sharded")


def test_pipelined_equals_serial(tmp_path, monkeypatch):
  data = image(ODD, seed=11)
  trees = []
  for mode in ("default", "off"):
    if mode == "off":
      monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
    root = tmp_path / mode
    JaxVolume.from_numpy(data, f"file://{root / 'src'}", resolution=(8, 8, 40), chunk_size=CHUNK)
    LocalTaskQueue(parallel=1).insert(tc.create_image_shard_transfer_tasks(
      f"file://{root / 'src'}", f"file://{root / 'dest'}", memory_target=int(2e5)))
    LocalTaskQueue(parallel=1).insert(tc.create_image_shard_downsample_tasks(
      f"file://{root / 'dest'}", num_mips=2, memory_target=int(8e5)))
    trees.append(layer_tree(root / "dest"))
  assert trees[0] == trees[1]


def test_payloads_cross_both_ways(tmp_path):
  """The JAX package's payloads run in the port, and write what the JAX
  package writes with them."""
  roots = _both(tmp_path, image((200, 150, 16), seed=12))
  for cls, make in [
    (ImageShardTransferTask, lambda r: jax_tc.create_image_shard_transfer_tasks(
      f"file://{r / 'src'}", f"file://{r / 'dest'}", memory_target=int(1e5))),
    (ImageShardDownsampleTask, lambda r: jax_tc.create_image_shard_downsample_tasks(
      f"file://{r / 'src'}", num_mips=1, memory_target=int(1e6))),
  ]:
    _jax_queue().insert(make(roots["jax"]))
    jax_tasks = list(make(roots["port"]))
    port_tasks = [deserialize(jax_serialize(t)) for t in jax_tasks]
    assert all(type(t) is cls for t in port_tasks)
    assert [t.payload()["params"] for t in port_tasks] == \
      [t.payload()["params"] for t in jax_tasks]
    for t in port_tasks:
      t.execute()
  for name in ("dest", "src"):
    assert layer_tree(roots["port"] / name) == layer_tree(roots["jax"] / name)


def test_graphene_options_on_a_plain_layer_raise_as_the_reference(tmp_path):
  """The graphene options (refused here until the port ran them) on a
  layer that is not graphene: the factories raise the JAX package's
  ``ValueError`` before anything is written; a task given a timestamp
  alone is made and reads no graphene state, in both."""
  roots = _both(tmp_path, image((128, 128, 16)))
  before = sorted(p.name for p in (roots["port"] / "src").rglob("*"))
  for mod, who in ((jax_tc, "jax"), (tc, "port")):
    src = f"file://{roots[who] / 'src'}"
    for kw, match in ((dict(agglomerate=True), "graphene"), (dict(timestamp=3.0), "timestamp"),
                      (dict(stop_layer=2), "graphene")):
      with pytest.raises(ValueError, match=match):
        mod.create_image_shard_transfer_tasks(src, f"file://{roots[who] / 'dest'}", **kw)
    with pytest.raises(ValueError, match="graphene"):
      mod.create_image_shard_downsample_tasks(src, agglomerate=True)
    assert not (roots[who] / "dest").exists()
  assert sorted(p.name for p in (roots["port"] / "src").rglob("*")) == before
  src = f"file://{roots['port'] / 'src'}"
  task = ImageShardDownsampleTask(src, (64, 64, 16), (0, 0, 0), timestamp=1.0)
  assert task.timestamp == 1.0 and not task.agglomerate


# ---------------------------------------------------------------------------
# the worker and the command lines

def test_worker_runs_sharded_members_solo(tmp_path, capsys):
  """``image xfer --sharded`` and ``image downsample --sharded`` through an
  fq:// queue and ``execute --batch 4``: every member runs solo, once, and
  the layer is the JAX command line's."""
  roots = _both(tmp_path, segmentation((301, 211, 16), seed=13))
  for args in (["image", "xfer", "file://ROOT/src", "file://ROOT/dest", "--sharded",
                "--memory", "400000"],
               ["image", "downsample", "file://ROOT/dest", "--sharded", "--num-mips", "2",
                "--memory", "800000"]):
    res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
    assert res.exit_code == 0, res.output
    spec = f"fq://{tmp_path / args[1]}"
    assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]
                    + ["--queue", spec]) == 0
    queue = FileQueue(spec)
    n = queue.enqueued
    capsys.readouterr()
    assert cli_main(["execute", spec, "--batch", "4", "-x"]) == 0
    out = capsys.readouterr().out
    assert n >= (4 if args[1] == "xfer" else 2)
    assert f"executed {n} tasks (0 batched in 0 dispatches, {n} solo, 0 failed" in out, out
    assert queue.completed == n and queue.enqueued == 0
  assert layer_tree(roots["port"] / "dest") == layer_tree(roots["jax"] / "dest")
  assert _prov(roots["port"], "dest") == _prov(roots["jax"], "dest")


@pytest.mark.parametrize("args", [
  ["image", "xfer", "file://ROOT/src", "file://ROOT/dest", "--sharded", "--memory", "200000",
   "--encoding", "png", "--encoding-level", "2", "--xrange", "128,512", "--cutout"],
  ["image", "xfer", "file://ROOT/src", "file://ROOT/dest", "--sharded", "--chunk-size",
   "128,128,16", "--translate", "0,64,0", "--dest-voxel-offset", "0,64,0"],
  ["image", "downsample", "file://ROOT/src", "--sharded", "--num-mips", "3", "--memory",
   "2000000", "--yrange", "0,256"],
  ["image", "downsample", "file://ROOT/src", "--sharded", "--volumetric", "--num-mips", "1"],
], ids=["xfer_png_cutout", "xfer_rechunk_translate", "downsample_range", "downsample_volumetric"])
def test_cli_sharded_matches_reference(tmp_path, args):
  roots = _both(tmp_path, image(ODD, seed=14))
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  name = "dest" if args[1] == "xfer" else "src"
  _assert_same(roots, name)


@pytest.mark.parametrize("args,message", [
  (["--sharded", "--isotropic"], "only the unsharded"),
  (["--isotropic", "--factor", "2,2,1"], "--isotropic excludes"),
  (["--isotropic", "--volumetric"], "--isotropic excludes"),
  (["--batched", "--sharded"], "--batched runs unsharded"),
  (["--batched", "--queue", "fq://./q"], "--batched runs unsharded"),
])
def test_cli_usage_errors_match_reference(tmp_path, capsys, args, message):
  roots = _both(tmp_path, image((128, 128, 16)))
  before = layer_tree(roots["port"] / "src")
  res = CliRunner().invoke(
    jax_cli, ["image", "downsample", f"file://{roots['jax'] / 'src'}", *args])
  assert res.exit_code == 2 and message in res.output
  with pytest.raises(SystemExit) as exc:
    cli_main(["image", "downsample", f"file://{roots['port'] / 'src'}", *args])
  assert exc.value.code == 2 and message in capsys.readouterr().err
  assert layer_tree(roots["port"] / "src") == before


# ---------------------------------------------------------------------------
# Volume: the repair

@pytest.fixture
def sharded_layer(tmp_path):
  """A 601x421x20 layer with a sharded mip 0 (and a sharded mip 1 with one
  shard missing) written by the JAX package, and its voxels."""
  data = image(ODD, seed=15)
  JaxVolume.from_numpy(data, f"file://{tmp_path / 'src'}", resolution=(8, 8, 40),
                       chunk_size=CHUNK)
  path = f"file://{tmp_path / 'layer'}"
  _jax_queue().insert(jax_tc.create_image_shard_transfer_tasks(
    f"file://{tmp_path / 'src'}", path, memory_target=int(2e5)))
  _jax_queue().insert(jax_tc.create_image_shard_downsample_tasks(
    path, num_mips=1, memory_target=int(1e6)))
  flush_local()
  return path, data


@pytest.mark.parametrize("fill_missing", [False, True])
def test_volume_reads_a_sharded_scale_as_the_reference(sharded_layer, fill_missing):
  path, data = sharded_layer
  for mip in (0, 1):
    port, ref = Volume(path, mip=mip, fill_missing=fill_missing), \
      JaxVolume(path, mip=mip, fill_missing=fill_missing)
    assert port.meta.is_sharded(mip) and port.meta.sharding(mip) == ref.meta.sharding(mip)
    for box in (port.bounds, Bbox((5, 70, 3), (250, 200, 19)), Bbox((64, 64, 0), (65, 65, 1))):
      got = port.download(box)
      np.testing.assert_array_equal(got, ref.download(JaxBbox(box.minpt, box.maxpt)))
      if mip == 0:
        sl = tuple(slice(int(a), int(b)) for a, b in zip(box.minpt, box.maxpt))
        np.testing.assert_array_equal(got[..., 0], data[sl])
  # unbounded reads past the bounds: background outside, as the reference
  box = Bbox((-10, 400, 0), (80, 500, 20))
  got = Volume(path, bounded=False, fill_missing=fill_missing).download(box)
  np.testing.assert_array_equal(
    got, JaxVolume(path, bounded=False, fill_missing=fill_missing).download(
      JaxBbox(box.minpt, box.maxpt)))


def test_volume_reads_a_missing_shard_as_the_reference(sharded_layer, tmp_path):
  path, _ = sharded_layer
  layer = tmp_path / "layer" / "8_8_40"
  victim = sorted(layer.iterdir())[0]
  victim.unlink()
  box = Volume(path).bounds
  with pytest.raises(EmptyVolumeError):
    Volume(path).download(box)
  with pytest.raises(Exception) as ref_exc:
    JaxVolume(path).download(JaxBbox(box.minpt, box.maxpt))
  assert type(ref_exc.value).__name__ == "EmptyVolumeError"
  np.testing.assert_array_equal(
    Volume(path, fill_missing=True, background_color=3).download(box),
    JaxVolume(path, fill_missing=True, background_color=3).download(
      JaxBbox(box.minpt, box.maxpt)))


def test_volume_refuses_a_direct_write_to_a_sharded_scale(sharded_layer, tmp_path):
  path, _ = sharded_layer
  before = layer_tree(tmp_path / "layer")
  box = Bbox((0, 0, 0), (64, 64, 16))
  img = np.zeros((64, 64, 16, 1), np.uint8)
  with pytest.raises(VolumeException) as got:
    Volume(path).upload(box, img)
  with pytest.raises(JaxVolumeException) as want:
    JaxVolume(path).upload(JaxBbox(box.minpt, box.maxpt), img)
  assert str(got.value) == str(want.value)
  assert "sharded" in str(got.value)
  assert layer_tree(tmp_path / "layer") == before


def test_meta_sharding_matches_reference(tmp_path):
  from igneous_tpu.meta import PrecomputedMetadata as JaxMeta

  spec = {"@type": "neuroglancer_uint64_sharded_v1", "preshift_bits": 3, "hash": "identity",
          "minishard_bits": 2, "shard_bits": 1, "minishard_index_encoding": "gzip",
          "data_encoding": "raw"}
  infos = []
  for Meta in (PrecomputedMetadata, JaxMeta):
    info = Meta.create_info(1, "image", "uint8", "raw", (8, 8, 40), (1, 2, 3), (300, 200, 50),
                            (64, 64, 16))
    meta = Meta(f"file://{tmp_path}/{Meta.__module__}", info=info)
    meta.add_scale((4, 4, 1), sharding=spec)
    meta.add_scale((2, 2, 1))
    meta.add_scale((2, 2, 1), sharding=dict(spec, shard_bits=0))  # an existing scale
    assert [meta.sharding(m) for m in range(3)] == [None, dict(spec, shard_bits=0), spec]
    assert [meta.is_sharded(m) for m in range(3)] == [False, True, True]
    assert meta.mip_from_resolution((32, 32, 40)) == 2
    assert meta.mip_from_resolution(np.array([16, 16, 40])) == 1
    with pytest.raises(KeyError):
      meta.mip_from_resolution((3, 3, 3))
    infos.append(meta.info)
  assert infos[0] == infos[1]


def _two_layers(tmp_path, data, chunk=(32, 32, 16)):
  paths = {}
  for side in ("jax", "port"):
    paths[side] = f"file://{tmp_path / side}"
    JaxVolume.from_numpy(data, paths[side], resolution=(8, 8, 40), chunk_size=chunk)
  return paths


def test_volume_exists_and_delete_match_reference(tmp_path):
  paths = _two_layers(tmp_path, image((100, 70, 20)))
  box = Bbox((32, 0, 0), (100, 64, 16))
  jbox = JaxBbox(box.minpt, box.maxpt)
  port, ref = Volume(paths["port"]), JaxVolume(paths["jax"])
  assert port.exists(box) == ref.exists(jbox) and all(port.exists(box).values())
  port.download(port.bounds)  # fills the decode cache
  port.delete(box)
  ref.delete(jbox)
  assert port.exists(port.bounds) == ref.exists(JaxBbox(ref.bounds.minpt, ref.bounds.maxpt))
  assert not any(port.exists(box).values())
  assert layer_tree(tmp_path / "port") == layer_tree(tmp_path / "jax")
  with pytest.raises(EmptyVolumeError):  # the cache does not serve a deleted chunk
    port.download(box)
  with pytest.raises(Exception, match="chunk aligned") as exc:
    port.delete(Bbox((1, 0, 0), (32, 32, 16)))
  assert type(exc.value).__name__ == "AlignmentError"


@pytest.mark.parametrize("encoding", ["raw", "compressed_segmentation"])
def test_volume_non_aligned_writes_match_reference(tmp_path, encoding):
  data = segmentation((100, 70, 20), seed=16)
  paths = {}
  for side in ("jax", "port"):
    paths[side] = f"file://{tmp_path / side}"
    JaxVolume.from_numpy(data, paths[side], resolution=(8, 8, 40), chunk_size=(32, 32, 16),
                         encoding=encoding)
  (tmp_path / "port" / "8_8_40" / "32-64_32-64_0-16.gz").unlink()  # a hole: background
  (tmp_path / "jax" / "8_8_40" / "32-64_32-64_0-16.gz").unlink()
  box = Bbox((5, 20, 3), (70, 60, 18))
  img = np.full((65, 40, 15), 2**40 + 1, np.uint64)
  Volume(paths["port"]).download(Bbox((0, 0, 0), (32, 32, 16)))  # fills the decode cache
  Volume(paths["port"], non_aligned_writes=True, background_color=9).upload(box, img)
  JaxVolume(paths["jax"], non_aligned_writes=True, background_color=9).upload(
    JaxBbox(box.minpt, box.maxpt), img)
  assert layer_tree(tmp_path / "port") == layer_tree(tmp_path / "jax")
  got = Volume(paths["port"]).download(Bbox((0, 0, 0), (100, 70, 20)))[..., 0]
  want = data.copy()
  want[32:64, 32:64, 0:16] = 9
  want[5:70, 20:60, 3:18] = 2**40 + 1
  np.testing.assert_array_equal(got, want)
  with pytest.raises(Exception) as exc:
    Volume(paths["port"]).upload(box, img)
  assert type(exc.value).__name__ == "AlignmentError"
