"""The port's transfer and downsample on real encodings, against the JAX
package.

Each case runs the same seeded layer through both packages and holds
every file the run writes byte for byte (chunks, ``info``, and
``provenance`` with its date and roots taken out): DownsampleTask on
compressed_segmentation (uint32, uint64), compresso, jpeg and png layers;
create_transfer_tasks from raw into compressed_segmentation with a
rechunk and each of its options, into the image codecs with an encoding
level, with compress none, gzip and auto (the reference with its
compressed-domain passthrough off, which the port does not have, and once
at its default on a passthrough-eligible transfer); mesh and skeleton
forge+merge from a compressed_segmentation source; a TransferTask payload
the JAX package serialized; ``image xfer`` and ``image downsample
--encoding`` on both command lines; and the refused options, which
write nothing.
"""

import json
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
from igneous_tpu.volume import AlignmentError as JaxAlignmentError
from igneous_tpu.volume import OutOfBoundsError as JaxOutOfBoundsError
from igneous_tpu_torch import Bbox, Volume, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import TransferTask
from igneous_tpu_torch.volume import AlignmentError, OutOfBoundsError

PASSTHROUGH = "IGNEOUS_TRANSFER_PASSTHROUGH"


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.delenv(PASSTHROUGH, raising=False)
  device.reset_device()
  yield
  device.reset_device()


def segmentation(shape, dtype=np.uint64, seed=0):
  """(x, y, z) labels in 3x3x2 cells of 5 ids and background; for uint64
  four ids lie above 2^32, one of them at or above 2^63."""
  rng = np.random.default_rng(seed)
  cells = rng.integers(0, 6, (shape[0] // 3 + 1, shape[1] // 3 + 1, shape[2] // 2 + 1))
  cells = np.kron(cells, np.ones((3, 3, 2), np.int64))[: shape[0], : shape[1], : shape[2]]
  if np.dtype(dtype) == np.uint64:
    ids = np.array([0, 2**40, 2**40 + 2**33 + 7, 2**63 + 5, 2**33, 77], np.uint64)
  else:
    ids = np.array([0, 1000, 70001, 2**31 + 3, 9, 4_000_000_000], np.uint64)
  return np.asfortranarray(ids[cells].astype(dtype))


def image(shape, dtype=np.uint8, channels=1, seed=0):
  """A smooth ramp plus noise, as EM imagery."""
  rng = np.random.default_rng(seed)
  ramp = np.add.outer(np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])),
                      3 * np.arange(shape[2]))[..., None]
  top = int(np.iinfo(dtype).max)
  arr = ramp * (top // 255) + rng.integers(0, top // 12, tuple(shape) + (channels,))
  return np.asfortranarray((arr % top).astype(dtype))


def _files(root: pathlib.Path):
  """Every file under ``root``; provenance with its dates dropped and the
  root's own path replaced, so two runs compare."""
  out = {}
  for p in sorted(root.rglob("*")):
    if not p.is_file():
      continue
    data = p.read_bytes()
    if p.name == "provenance":
      prov = json.loads(data)
      for entry in prov["processing"]:
        entry.pop("date")
      data = json.dumps(prov, sort_keys=True).replace(str(root), "ROOT").encode()
    out[str(p.relative_to(root))] = data
  return out


def assert_same_tree(port_root: pathlib.Path, jax_root: pathlib.Path, min_files=3):
  got, want = _files(port_root), _files(jax_root)
  assert len(want) >= min_files
  assert sorted(got) == sorted(want)
  assert [k for k in want if got[k] != want[k]] == []


def _sources(tmp_path, data, **kw):
  """The same source layer under tmp/jax and tmp/port, written by the JAX
  package."""
  roots = {}
  for who in ("jax", "port"):
    roots[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{roots[who] / 'src'}", **kw)
  return roots


# ---------------------------------------------------------------------------
# DownsampleTask on encoded layers

DS_LAYERS = {
  "cseg_uint32": (lambda: segmentation((96, 80, 32), np.uint32),
                  dict(encoding="compressed_segmentation"), {}),
  "cseg_uint64": (lambda: segmentation((96, 80, 32)),
                  dict(encoding="compressed_segmentation"), {}),
  "cseg_uint64_sparse_auto": (lambda: segmentation((96, 80, 32), seed=3),
                              dict(encoding="compressed_segmentation"),
                              dict(sparse=True, compress="auto")),
  "compresso_uint64": (lambda: segmentation((96, 80, 32), seed=1),
                       dict(encoding="compresso"), {}),
  "jpeg_uint8": (lambda: image((96, 80, 32)), dict(encoding="jpeg"), {}),
  "jpeg_uint8_level_auto": (lambda: image((96, 80, 32), channels=3),
                            dict(encoding="jpeg", compress=False),
                            dict(encoding_level=50, compress="auto")),
  "png_uint8": (lambda: image((96, 80, 32)), dict(encoding="png"),
                dict(encoding_level=2)),
  "png_uint16_none": (lambda: image((96, 80, 32), np.uint16), dict(encoding="png"),
                      dict(compress=False)),
  "raw_to_cseg_scales": (lambda: segmentation((96, 80, 32), seed=4), {},
                         dict(encoding="compressed_segmentation", compress="auto")),
}


@pytest.mark.parametrize("name", sorted(DS_LAYERS))
def test_downsample_on_encoded_layers_matches_reference(tmp_path, name):
  make, vol_kw, ds_kw = DS_LAYERS[name]
  roots = _sources(tmp_path, make(), resolution=(8, 8, 40), chunk_size=(32, 32, 16),
                   **vol_kw)
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_downsampling_tasks(f"file://{roots['jax'] / 'src'}", num_mips=2, **ds_kw))
  LocalTaskQueue().insert(
    tc.create_downsampling_tasks(f"file://{roots['port'] / 'src'}", num_mips=2, **ds_kw))
  assert_same_tree(roots["port"], roots["jax"], min_files=20)
  info = json.loads((roots["port"] / "src" / "info").read_text())
  assert len(info["scales"]) == 3
  if "encoding" in vol_kw:
    want = "compresso-cpsx" if vol_kw["encoding"] == "compresso" else vol_kw["encoding"]
    assert {s["encoding"] for s in info["scales"]} == {want}


# ---------------------------------------------------------------------------
# create_transfer_tasks

SRC_SHAPE = (128, 96, 48)
CSEG = dict(encoding="compressed_segmentation", chunk_size=(32, 32, 32))

XFER_CASES = {
  # name: (source kind, source mips, factory keywords); the default source
  # is a raw uint64 segmentation in 64^3 chunks, tasks of 64x64x32
  "rechunk_cseg": ("seg", 0, dict(**CSEG, num_mips=2)),
  "rechunk_cseg_compress_none": ("seg", 0, dict(**CSEG, num_mips=1, compress=None)),
  "rechunk_cseg_compress_auto": ("seg", 0, dict(**CSEG, num_mips=1, compress="auto")),
  "translate": ("seg", 0, dict(**CSEG, num_mips=2, translate=(5, 7, 3))),
  "dest_voxel_offset": ("seg", 0, dict(**CSEG, num_mips=1, translate=(64, 32, 0),
                                       dest_voxel_offset=(64, 32, 0))),
  "cutout_bounds": ("seg", 0, dict(**CSEG, num_mips=2, cutout=True,
                                   bounds=((32, 32, 0), (96, 96, 48)))),
  "bounds_no_cutout": ("seg", 0, dict(**CSEG, num_mips=1, bounds=((64, 0, 0), (128, 64, 48)))),
  "no_truncate_scales": ("seg", 2, dict(**CSEG, num_mips=0, truncate_scales=False)),
  "mip1_truncate_scales": ("seg", 2, dict(**CSEG, mip=1, num_mips=1)),
  "clean_info_no_src_update": ("seg", 0, dict(**CSEG, num_mips=1, clean_info=True,
                                              no_src_update=True)),
  "use_https_for_source": ("seg", 0, dict(**CSEG, num_mips=1, use_https_for_source=True)),
  "skip_first": ("seg", 0, dict(**CSEG, num_mips=2, skip_first=True)),
  "skip_downsamples": ("seg", 0, dict(**CSEG, num_mips=2, skip_downsamples=True)),
  "max_mips": ("seg", 0, dict(**CSEG, num_mips=3, max_mips=1)),
  "sparse": ("seg", 0, dict(**CSEG, num_mips=2, sparse=True)),
  "delete_black_uploads": ("sparse_seg", 0, dict(**CSEG, num_mips=1, delete_black_uploads=True)),
  "fill_missing": ("holes", 0, dict(**CSEG, num_mips=1, fill_missing=True)),
  "uint32_compresso": ("seg32", 0, dict(encoding="compresso", chunk_size=(32, 32, 16),
                                        num_mips=1)),
  "memory_target_shape": ("seg", 0, dict(**CSEG, num_mips=2, shape=None,
                                         memory_target=2 * 64 * 64 * 32 * 8)),
  "jpeg_level": ("image", 0, dict(encoding="jpeg", encoding_level=70, num_mips=2,
                                  chunk_size=(32, 32, 16), compress="auto")),
  "jpeg_default_gzip": ("image", 0, dict(encoding="jpeg", num_mips=1,
                                         chunk_size=(32, 32, 16))),
  "png_level": ("image", 0, dict(encoding="png", encoding_level=1, num_mips=1,
                                 chunk_size=(32, 32, 16), compress=None)),
  "png_uint16_volumetric": ("image16", 0, dict(encoding="png", num_mips=1, factor=(2, 2, 2),
                                               chunk_size=(32, 32, 16))),
  "raw_average_rechunk": ("image", 0, dict(chunk_size=(16, 16, 16), num_mips=2)),
}


def _xfer_source(kind, seed=0):
  if kind == "seg32":
    return segmentation(SRC_SHAPE, np.uint32, seed)
  if kind == "image":
    return image(SRC_SHAPE, seed=seed)
  if kind == "image16":
    return image(SRC_SHAPE, np.uint16, seed=seed)
  data = segmentation(SRC_SHAPE, seed=seed)
  if kind == "sparse_seg":
    data[:64, :64] = 0  # whole chunks of background
  return data


def _transfer_both(tmp_path, monkeypatch, kind, src_mips, kw, passthrough=False):
  data = _xfer_source(kind)
  roots = _sources(tmp_path, data, resolution=(8, 8, 40), chunk_size=(64, 64, 64))
  if kind == "holes":
    for who in roots:  # a missing chunk, read back as background
      (roots[who] / "src" / "8_8_40" / "64-128_0-64_0-48.gz").unlink()
  for who in roots:
    if src_mips:
      JaxQueue(parallel=1, progress=False).insert(jax_tc.create_downsampling_tasks(
        f"file://{roots[who] / 'src'}", num_mips=src_mips))
  kw = dict(kw)
  kw.setdefault("shape", (64, 64, 32))
  bounds = kw.pop("bounds", None)
  for who in ("jax", "port"):
    make = jax_tc.create_transfer_tasks if who == "jax" else tc.create_transfer_tasks
    extra = {} if bounds is None else {"bounds": (JaxBbox if who == "jax" else Bbox)(*bounds)}
    # the reference decodes and re-encodes, as the port does, unless a
    # case asks for its default
    if who == "jax" and not passthrough:
      monkeypatch.setenv(PASSTHROUGH, "off")
    tasks = make(f"file://{roots[who] / 'src'}", f"file://{roots[who] / 'dest'}", **kw, **extra)
    if who == "jax":
      JaxQueue(parallel=1, progress=False).insert(tasks)
    else:
      LocalTaskQueue().insert(tasks)
    monkeypatch.delenv(PASSTHROUGH, raising=False)
  return roots


@pytest.mark.parametrize("case", sorted(XFER_CASES))
def test_transfer_matches_reference(tmp_path, monkeypatch, case):
  kind, src_mips, kw = XFER_CASES[case]
  roots = _transfer_both(tmp_path, monkeypatch, kind, src_mips, kw)
  assert_same_tree(roots["port"], roots["jax"], min_files=8)
  dest = Volume(f"file://{roots['port'] / 'dest'}")
  enc = kw.get("encoding", "raw")
  assert dest.meta.encoding(0) == ("compresso-cpsx" if enc == "compresso" else enc)


def test_transfer_reads_back_the_source(tmp_path, monkeypatch):
  """Beyond parity: the rechunked cseg copy holds the source's voxels,
  translated, and each mip the port's downsample of them."""
  from igneous_tpu_torch.ops import pooling

  kind, _, kw = XFER_CASES["translate"]
  roots = _transfer_both(tmp_path, monkeypatch, kind, 0, kw)
  data = _xfer_source(kind)
  dest = Volume(f"file://{roots['port'] / 'dest'}")
  assert dest.meta.cseg_block_size(0) == (8, 8, 8)
  got = dest.download(dest.mip_bounds(0))[..., 0]
  assert dest.mip_bounds(0).minpt == (5, 7, 3) and np.array_equal(got, data)
  mips = pooling.downsample(data, (2, 2, 1), dest.meta.num_mips - 1, method="mode")
  assert len(mips) >= 1
  for mip, want in enumerate(mips, start=1):
    got = Volume(f"file://{roots['port'] / 'dest'}", mip=mip)
    # each task's cutout starts on the source's even grid, so the
    # translated pyramid is the source's pyramid
    assert np.array_equal(got.download(got.mip_bounds(mip))[..., 0], want)


def test_passthrough_eligible_transfer_matches_the_reference_default(tmp_path, monkeypatch):
  """Same chunking and encoding, no resampling: the reference moves the
  stored bytes; the port decodes and re-encodes them to the same bytes."""
  data = segmentation(SRC_SHAPE, seed=2)
  roots = {}
  for who in ("jax", "port"):
    roots[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{roots[who] / 'src'}", resolution=(8, 8, 40),
                         chunk_size=(64, 64, 32), encoding="compressed_segmentation")
  kw = dict(skip_downsamples=True, shape=(64, 64, 32))
  JaxQueue(parallel=1, progress=False).insert(jax_tc.create_transfer_tasks(
    f"file://{roots['jax'] / 'src'}", f"file://{roots['jax'] / 'dest'}", **kw))
  LocalTaskQueue().insert(tc.create_transfer_tasks(
    f"file://{roots['port'] / 'src'}", f"file://{roots['port'] / 'dest'}", **kw))
  assert_same_tree(roots["port"], roots["jax"], min_files=12)


@pytest.mark.parametrize("case,error", [
  ("dest_voxel_offset_alone", (OutOfBoundsError, JaxOutOfBoundsError)),
  ("off_grid_translate", (AlignmentError, JaxAlignmentError)),
])
def test_unwritable_transfers_raise_before_writing(tmp_path, case, error):
  """Where the reference's upload refuses a box, the port's upload raises
  the same class before it writes any chunk."""
  data = segmentation((64, 64, 32))
  roots = _sources(tmp_path, data, resolution=(8, 8, 40), chunk_size=(32, 32, 32))
  kw = dict(chunk_size=(32, 32, 32), shape=(32, 32, 32), num_mips=0)
  if case == "dest_voxel_offset_alone":
    kw["dest_voxel_offset"] = (16, 0, 0)
  else:
    kw["translate"] = (8, 0, 0)
  for who, make, queue in (("jax", jax_tc.create_transfer_tasks, JaxQueue(progress=False)),
                           ("port", tc.create_transfer_tasks, LocalTaskQueue())):
    tasks = list(make(f"file://{roots[who] / 'src'}", f"file://{roots[who] / 'dest'}", **kw))
    if case == "off_grid_translate":
      # the new layer's origin moves with the translation; re-anchor it so
      # the written boxes are off its grid
      info_path = roots[who] / "dest" / "info"
      info = json.loads(info_path.read_text())
      info["scales"][0]["voxel_offset"] = [0, 0, 0]
      info_path.write_text(json.dumps(info))
    with pytest.raises(error[0] if who == "port" else error[1]):
      tasks[0].execute()
  assert sorted(p.name for p in (roots["port"] / "dest").iterdir()) == ["info", "provenance"]


def test_reference_payload_writes_cseg_in_the_port(tmp_path, monkeypatch):
  """TransferTask payloads serialized by the JAX package, into a cseg
  destination, write the reference's bytes when the port executes them."""
  data = segmentation(SRC_SHAPE, seed=6)
  roots = _sources(tmp_path, data, resolution=(8, 8, 40), chunk_size=(64, 64, 64))
  monkeypatch.setenv(PASSTHROUGH, "off")
  for who in ("jax", "port"):
    tasks = list(jax_tc.create_transfer_tasks(
      f"file://{roots[who] / 'src'}", f"file://{roots[who] / 'dest'}",
      shape=(64, 64, 32), num_mips=2, **CSEG))
    assert len(tasks) == 2 * 2 * 2
    for task in tasks:
      if who == "jax":
        task.execute()
      else:
        ported = deserialize(jax_serialize(task))
        assert type(ported) is TransferTask
        assert ported._params == task._params
        ported.execute()
  assert_same_tree(roots["port"], roots["jax"], min_files=40)


# ---------------------------------------------------------------------------
# mesh and skeleton paths reading compressed_segmentation


def _blobs(shape, seed=0):
  """A few labelled balls, ids above 2^32 and one above 2^63."""
  rng = np.random.default_rng(seed)
  grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
  out = np.zeros(shape, np.uint64)
  for i, label in enumerate((2**40 + 3, 2**33, 2**63 + 9, 77, 2**40 + 2**35)):
    c = rng.random(3) * shape
    out[((grid - c) ** 2 / np.array([1.0, 1.0, 0.5])).sum(-1) < rng.uniform(60, 150)] = label
  return np.asfortranarray(out)


@pytest.mark.parametrize("path", ["mesh", "skeleton"])
def test_forge_and_merge_from_cseg_match_raw_and_reference(tmp_path, path):
  data = _blobs((48, 40, 24))
  roots = {}
  for who, enc in (("raw", "raw"), ("port", "compressed_segmentation"),
                   ("jax", "compressed_segmentation")):
    roots[who] = tmp_path / who
    JaxVolume.from_numpy(data, f"file://{roots[who]}", resolution=(8, 8, 40),
                         chunk_size=(16, 16, 8), layer_type="segmentation", encoding=enc)
  shape = (32, 32, 32) if path == "mesh" else (32, 24, 24)
  for who, root in roots.items():
    lib = jax_tc if who == "jax" else tc
    queue = JaxQueue(parallel=1, progress=False) if who == "jax" else LocalTaskQueue()
    layer = f"file://{root}"
    if path == "mesh":
      queue.insert(lib.create_meshing_tasks(layer, shape=shape))
      queue.insert(lib.create_mesh_manifest_tasks(layer))
    else:
      queue.insert(lib.create_skeletonizing_tasks(layer, shape=shape, dust_threshold=10,
                                                  teasar_params={"scale": 4, "const": 50}))
      queue.insert(lib.create_unsharded_skeleton_merge_tasks(layer, dust_threshold=0,
                                                            tick_threshold=0))

  def products(root):
    return {k: v for k, v in _files(root).items()
            if "/" in k and not k.startswith("8_8_40/")}

  got = products(roots["port"])
  assert len(got) > 4
  assert got == products(roots["raw"])
  assert got == products(roots["jax"])


# ---------------------------------------------------------------------------
# the command line


def _cli_both(tmp_path, data, jax_args, port_args=None, **vol_kw):
  roots = _sources(tmp_path, data, resolution=(8, 8, 40), **vol_kw)
  port_args = jax_args if port_args is None else port_args
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in jax_args])
  assert res.exit_code == 0, res.output
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in port_args]) == 0
  return roots


@pytest.mark.parametrize("opts", [
  ["--chunk-size", "32,32,32", "--encoding", "compressed_segmentation", "--max-mips", "2",
   "--shape", "64,64,32", "--translate", "5,7,3"],
  ["--encoding", "compresso", "--skip-downsample", "--compress", "none",
   "--xrange", "0,64", "--yrange", "32,96", "--cutout", "--no-src-update",
   "--shape", "64,64,48"],
  ["--chunk-size", "32,32,16", "--encoding", "compressed_segmentation", "--num-mips", "1",
   "--memory", str(64 * 64 * 48 * 8 * 2), "--sparse", "--dest-voxel-offset", "8,8,8",
   "--translate", "8,8,8", "--compress", "auto"],
], ids=["cseg_translate", "compresso_cutout", "cseg_memory_offset"])
def test_cli_xfer_matches_reference(tmp_path, monkeypatch, opts):
  monkeypatch.setenv(PASSTHROUGH, "off")  # read by the reference only
  args = ["image", "xfer", "file://ROOT/src", "file://ROOT/dest", *opts]
  roots = _cli_both(tmp_path, segmentation(SRC_SHAPE, seed=8), args, chunk_size=(64, 64, 64))
  assert_same_tree(roots["port"], roots["jax"], min_files=8)


@pytest.mark.parametrize("opts,kind", [
  (["--encoding", "compressed_segmentation", "--compress", "auto"], "seg"),
  (["--encoding", "jpeg", "--encoding-level", "60", "--factor", "2,2,1"], "image"),
  (["--encoding", "png", "--compress", "gzip", "--volumetric"], "image"),
])
def test_cli_downsample_encoding_matches_reference(tmp_path, opts, kind):
  data = segmentation((96, 80, 32)) if kind == "seg" else image((96, 80, 32))
  args = ["image", "downsample", "file://ROOT/src", "--num-mips", "2", *opts]
  roots = _cli_both(tmp_path, data, args, chunk_size=(32, 32, 16))
  assert_same_tree(roots["port"], roots["jax"], min_files=12)


def test_cli_xfer_defaults_match_reference(tmp_path, monkeypatch):
  """Every default: same encoding and chunking, five mips asked."""
  monkeypatch.setenv(PASSTHROUGH, "off")
  args = ["image", "xfer", "file://ROOT/src", "file://ROOT/dest"]
  roots = _cli_both(tmp_path, segmentation((128, 128, 16), seed=9), args,
                    chunk_size=(32, 32, 16), encoding="compressed_segmentation")
  assert_same_tree(roots["port"], roots["jax"], min_files=20)


# ---------------------------------------------------------------------------
# refusals


@pytest.mark.parametrize("option", ["agglomerate", "timestamp", "stop_layer",
                                    "sharded_source", "sharded_dest", "cli_sharded"])
def test_refused_options_write_nothing(tmp_path, option):
  data = segmentation((64, 64, 32))
  src = tmp_path / "src"
  JaxVolume.from_numpy(data, f"file://{src}", resolution=(8, 8, 40), chunk_size=(32, 32, 32))
  dest = tmp_path / "dest"
  before = _files(src)
  kw = {"agglomerate": dict(agglomerate=True), "timestamp": dict(timestamp=5.0),
        "stop_layer": dict(stop_layer=2)}.get(option, {})
  if option == "sharded_source":
    info = json.loads((src / "info").read_text())
    info["scales"][0]["sharding"] = {"@type": "neuroglancer_uint64_sharded_v1"}
    (src / "info").write_text(json.dumps(info))
    before = _files(src)
  if option == "sharded_dest":
    JaxVolume.from_numpy(data, f"file://{dest}", resolution=(8, 8, 40), chunk_size=(32, 32, 32))
    info = json.loads((dest / "info").read_text())
    info["scales"][0]["sharding"] = {"@type": "neuroglancer_uint64_sharded_v1"}
    (dest / "info").write_text(json.dumps(info))
    dest_before = _files(dest)
  with pytest.raises(NotImplementedError):
    if option == "cli_sharded":
      cli_main(["image", "xfer", f"file://{src}", f"file://{dest}", "--sharded"])
    else:
      tc.create_transfer_tasks(f"file://{src}", f"file://{dest}", **kw)
  assert _files(src) == before
  if option == "sharded_dest":
    assert _files(dest) == dest_before
  else:
    assert not dest.exists()


def test_graphene_payload_is_refused():
  payload = {"class": "TransferTask", "module": "igneous_tpu.tasks.image", "params": {
    "src_path": "graphene://x", "dest_path": "file:///nonexistent", "mip": 0,
    "shape": [64, 64, 64], "offset": [0, 0, 0], "agglomerate": True, "timestamp": 1.0}}
  with pytest.raises(NotImplementedError, match="graphene"):
    deserialize(payload)
