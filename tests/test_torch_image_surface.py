"""The rest of the image surface in the port, against the JAX package.

``compute_rois`` and ``image roi`` (suppressed faint voxels, z slabs, the
in-memory 2x2x1 downsample, odd extents, many components whose C-order and
Fortran-order first voxels disagree): the same ROI list in the same order
and the same info file. ``ops.ccl.statistics`` on labels with gaps: counts,
boxes and centroids (NaN for the background and absent labels) bit for
bit. ``SpatialIndexTask`` (uint32, uint64 ids at or above 2^63, signed ids
below 0) and ``mesh|skeleton spatial-index create``: the same ``.spatial``
bytes. ``ReorderTask`` and ``image reorder`` (positional mapping and
``--mapping-file``), and ``image create`` from npy, npy.gz, NRRD, NIfTI
(.nii and .nii.gz) and HDF5: equal layers. The tolerance is bitwise
throughout.
"""

import gzip
import json
import struct
import sys

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import formats as jax_formats
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.ops.ccl import statistics as jax_statistics
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import formats
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.ops.ccl import statistics
from igneous_tpu_torch.queues import deserialize
from igneous_tpu_torch.tasks import ReorderTask, SpatialIndexTask

from test_torch_contrast import _torch_cpu, both, image, layers, tree  # noqa: F401
from test_torch_integrity import flush_local, layer_tree

SHAPE = (301, 211, 20)


def _rois_both(roots, name="src", **kw):
  out = {}
  for side, lib in (("jax", jax_tc), ("port", tc)):
    out[side] = [str(r) for r in lib.compute_rois(f"file://{roots[side] / name}", **kw)]
  assert out["port"] == out["jax"]
  assert ((roots["port"] / name / "info").read_bytes()
          == (roots["jax"] / name / "info").read_bytes())
  return out["port"]


def _blobs(shape, n, seed, dtype=np.uint8):
  """``n`` bright boxes of random size on a dark noisy floor."""
  rng = np.random.default_rng(seed)
  img = rng.integers(0, 40, shape).astype(dtype)
  for _ in range(n):
    lo = [int(rng.integers(0, s - 2)) for s in shape]
    hi = [min(s, a + int(rng.integers(2, max(3, s // 4)))) for a, s in zip(lo, shape)]
    img[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.integers(150, 250)
  return np.asfortranarray(img)


# ---------------------------------------------------------------------------
# ROIs


def test_rois_suppress_faint_and_z_step_match_reference(tmp_path):
  img = np.zeros((64, 64, 8), dtype=np.uint8)
  img[8:24, 8:24, 0:4] = 200
  img[40:56, 40:56, 4:8] = 200
  img[0:4, 60:64, :] = 3
  roots = layers(tmp_path, img, chunk_size=(32, 32, 8), layer_type="image")
  rois = _rois_both(roots, mip=0, suppress_faint_voxels=10, dust_threshold=10, z_step=4)
  assert len(rois) == 2
  rois = _rois_both(roots, mip=0, dust_threshold=10, z_step=4)
  assert len(rois) == 4  # the faint smear in each slab


def test_rois_max_axial_downsample_match_reference(tmp_path):
  img = np.zeros((128, 128, 4), dtype=np.uint8)
  img[16:112, 16:112, :] = 250
  roots = layers(tmp_path, img, chunk_size=(64, 64, 4), layer_type="image")
  assert len(_rois_both(roots, mip=0, max_axial_length=32, dust_threshold=1)) == 1


def test_rois_threshold_and_dust_match_reference(tmp_path):
  data = np.zeros((128, 128, 32), np.uint8)
  data[10:50, 10:50, 5:25] = 200
  data[90:120, 80:120, 5:25] = 180
  roots = layers(tmp_path, data, chunk_size=(64, 64, 32))
  assert len(_rois_both(roots, threshold=10, dust_threshold=10)) == 2


@pytest.mark.parametrize("kw", [
  dict(),
  dict(max_axial_length=40),  # three rounds on odd extents
  dict(max_axial_length=60, z_step=5, dust_threshold=20),
  dict(threshold=100, suppress_faint_voxels=160, dust_threshold=1),
], ids=["defaults", "odd_rounds", "z_step", "suppress"])
def test_rois_of_many_components_match_reference(tmp_path, kw):
  # many components: their order by first voxel differs between C order
  # (x slowest, ndimage.label's) and Fortran order (the port's labelling)
  img = _blobs((97, 83, 12), 40, seed=3)
  roots = layers(tmp_path, img, chunk_size=(32, 32, 12))
  rois = _rois_both(roots, **{"threshold": 100, "dust_threshold": 5, **kw})
  assert len(rois) > 5


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_rois_of_other_types_match_reference(tmp_path, dtype):
  img = _blobs((90, 70, 6), 12, seed=5).astype(dtype) * 3
  roots = layers(tmp_path, img, chunk_size=(32, 32, 6), layer_type="image")
  assert len(_rois_both(roots, threshold=300, max_axial_length=30, dust_threshold=2)) > 1


def test_rois_at_the_coarsest_mip_match_reference(tmp_path):
  roots = layers(tmp_path, _blobs((128, 96, 16), 15, seed=7), chunk_size=(32, 32, 16))
  both(roots, lambda lib, path, side: lib.create_downsampling_tasks(path, num_mips=2))
  assert len(_rois_both(roots, threshold=90, dust_threshold=2)) > 1


def test_cli_image_roi_matches_reference(tmp_path, capsys):
  roots = layers(tmp_path, _blobs((97, 83, 12), 25, seed=11), chunk_size=(32, 32, 12))
  args = ["image", "roi", "file://ROOT/src", "--threshold", "100", "--dust", "4",
          "--max-axial-len", "50", "--z-step", "6", "--suppress-faint", "30"]
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  capsys.readouterr()
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  assert capsys.readouterr().out == res.output
  assert "ROI detected. info file updated." in res.output
  assert ((roots["port"] / "src" / "info").read_bytes()
          == (roots["jax"] / "src" / "info").read_bytes())


def test_cli_image_roi_progress_without_tqdm(tmp_path, capsys, monkeypatch):
  """``--progress`` needs no tqdm: its lines go to stderr, and stdout
  holds the JAX CLI's ROI lines, as without ``--progress``."""
  roots = layers(tmp_path, _blobs((97, 83, 12), 25, seed=11), chunk_size=(32, 32, 12))
  args = ["image", "roi", "file://ROOT/src", "--threshold", "100", "--dust", "4",
          "--z-step", "4"]
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  monkeypatch.setitem(sys.modules, "tqdm", None)  # any import of it raises
  capsys.readouterr()
  port = [a.replace("ROOT", str(roots["port"])) for a in args]
  assert cli_main(port + ["--progress"]) == 0
  out = capsys.readouterr()
  assert out.out == res.output
  assert "ROI detected. info file updated." in out.out
  assert out.err.splitlines() == [f"ROI z-slabs: {i}/3" for i in (1, 2, 3)]
  assert cli_main(port) == 0
  assert capsys.readouterr().out == res.output


# ---------------------------------------------------------------------------
# statistics


def test_statistics_of_an_empty_volume_raise_in_both():
  lab = np.zeros((0, 4, 4), np.uint32)
  for fn in (statistics, jax_statistics):
    with pytest.raises(ValueError):
      fn(lab)


@pytest.mark.parametrize("case", ["gaps", "blobs", "background_only"])
def test_statistics_match_reference(case):
  if case == "gaps":
    lab = np.zeros((12, 10, 8), np.uint32)
    lab[1:4, 2:5, 3:6] = 1
    lab[8:11, 0:2, 0:4] = 3
    lab[5, 9, 7] = 7  # labels 2, 4, 5 and 6 absent
    lab[0, 0, 0] = 7
  elif case == "blobs":
    from scipy import ndimage

    lab = ndimage.label(_blobs((41, 37, 13), 30, seed=2) > 100)[0].astype(np.uint16)
  else:
    lab = np.zeros((5, 6, 7), np.uint8)
  got, want = statistics(lab), jax_statistics(lab)
  assert got["voxel_counts"].dtype == want["voxel_counts"].dtype == np.uint64
  np.testing.assert_array_equal(got["voxel_counts"], want["voxel_counts"])
  assert got["bounding_boxes"] == want["bounding_boxes"]
  assert got["centroids"].shape == want["centroids"].shape
  assert got["centroids"].tobytes() == want["centroids"].tobytes()  # NaNs included


# ---------------------------------------------------------------------------
# the spatial index


def _segmentation(kind):
  rng = np.random.default_rng(4)
  shape = (70, 64, 24)
  ids = rng.integers(0, 9, shape)
  ids = np.repeat(np.repeat(ids[::7, ::8, ::6], 7, 0), 8, 1).repeat(6, 2)[:70, :64, :24]
  if kind == "uint64":
    table = np.array([0, 5, 2**40, 2**63, 2**63 + 9, 2**64 - 1, 77, 2**33, 3], np.uint64)
  elif kind == "int32":
    table = np.array([0, -5, 7, -2**31, 2**31 - 1, 12, -1, 40, 3], np.int32)
  else:
    table = np.array([0, 9, 2**20, 4, 2**32 - 1, 17, 8, 100, 3], np.uint32)
  return np.asfortranarray(table[ids])


@pytest.mark.parametrize("kind", ["uint32", "uint64", "int32"])
def test_spatial_index_tasks_match_reference(tmp_path, kind):
  roots = layers(tmp_path, _segmentation(kind), chunk_size=(32, 32, 24),
                 layer_type="segmentation")
  tasks = both(roots, lambda lib, path, side: lib.create_spatial_index_tasks(
    path, "six", shape=(48, 40, 24)))
  assert all(type(t) is SpatialIndexTask for t in tasks["port"])
  files = sorted(p.name for p in (roots["port"] / "src" / "six").iterdir())
  assert len(files) == 4
  for name in files:
    assert ((roots["port"] / "src" / "six" / name).read_bytes()
            == (roots["jax"] / "src" / "six" / name).read_bytes())
  assert layer_tree(roots["port"] / "src") == layer_tree(roots["jax"] / "src")


def test_spatial_index_payload_from_reference_runs(tmp_path):
  roots = layers(tmp_path, _segmentation("uint64"), chunk_size=(32, 32, 24),
                 layer_type="segmentation")
  for side in roots:
    for t in jax_tc.create_spatial_index_tasks(f"file://{roots[side] / 'src'}", "six"):
      (t if side == "jax" else deserialize(jax_serialize(t))).execute()
  assert layer_tree(roots["port"] / "src") == layer_tree(roots["jax"] / "src")


@pytest.mark.parametrize("group,flag", [("mesh", "--mesh-dir"), ("skeleton", "--skel-dir")])
def test_cli_spatial_index_create_matches_reference(tmp_path, group, flag):
  roots = layers(tmp_path, _segmentation("uint64"), chunk_size=(32, 32, 24),
                 layer_type="segmentation")
  for side in roots:  # the directory named in the info
    info = json.loads((roots[side] / "src" / "info").read_text())
    info["mesh" if group == "mesh" else "skeletons"] = "from_info"
    (roots[side] / "src" / "info").write_text(json.dumps(info))
  for extra in ([flag, "idx2", "--shape", "35,64,24"], []):
    args = [group, "spatial-index", "create", "file://ROOT/src", *extra]
    res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
    assert res.exit_code == 0, res.output
    assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  assert (roots["port"] / "src" / "from_info").is_dir()
  assert layer_tree(roots["port"] / "src") == layer_tree(roots["jax"] / "src")


# ---------------------------------------------------------------------------
# reorder


@pytest.mark.parametrize("kw", [
  dict(z_per_task=3),
  dict(z_per_task=16, compress=None, delete_black_uploads=True),
  dict(z_per_task=4, encoding="compressed_segmentation"),
], ids=["reverse", "no_compress_delete_bg", "cseg"])
def test_reorder_tasks_match_reference(tmp_path, kw):
  data = image(SHAPE)
  data[:, :, 5] = 0  # a black slice for delete_black_uploads
  roots = layers(tmp_path, data, chunk_size=(64, 64, 1))
  mapping = {z: 19 - z for z in range(20)}
  mapping.pop(7)  # a z the mapping leaves in place
  tasks = both(roots, lambda lib, path, side: lib.create_reordering_tasks(
    path, path.replace("/src", "/dest"), mapping, **kw))
  assert all(type(t) is ReorderTask for t in tasks["port"])
  assert tree(roots["port"], "dest") == tree(roots["jax"], "dest")
  dest = JaxVolume(f"file://{roots['port'] / 'dest'}", fill_missing=True)
  order = [mapping.get(z, z) for z in range(20)]
  np.testing.assert_array_equal(dest.download(dest.bounds)[..., 0], data[:, :, order])
  if kw.get("delete_black_uploads"):  # the black slice went nowhere
    assert not list((roots["port"] / "dest" / "8_8_40").glob("*_14-15*"))


@pytest.mark.parametrize("form", ["positional", "flag"])
def test_cli_image_reorder_matches_reference(tmp_path, form):
  roots = layers(tmp_path, image(SHAPE), chunk_size=(64, 64, 1))
  mf = tmp_path / "mapping.json"
  mf.write_text(json.dumps({str(z): 19 - z for z in range(20)}))
  mapping = [str(mf)] if form == "positional" else ["--mapping-file", str(mf)]
  args = ["image", "reorder", "file://ROOT/src", "file://ROOT/dest", *mapping,
          "--compress", "none"]
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  assert tree(roots["port"], "dest") == tree(roots["jax"], "dest")
  with pytest.raises(SystemExit) as err:
    cli_main(["image", "reorder", f"file://{roots['port'] / 'src'}", "file://x"])
  assert err.value.code == 2


# ---------------------------------------------------------------------------
# image create


def _nrrd(path, arr, encoding="raw"):
  names = {np.uint8: "uint8", np.uint16: "uint16", np.uint64: "uint64"}
  body = np.asfortranarray(arr).tobytes(order="F")
  if encoding == "gzip":
    body = gzip.compress(body, mtime=0)
  header = (f"NRRD0004\ntype: {names[arr.dtype.type]}\ndimension: 3\n"
            f"sizes: {' '.join(map(str, arr.shape))}\nencoding: {encoding}\n"
            "endian: little\n\n").encode()
  path.write_bytes(header + body)


def _nifti(path, arr):
  codes = {np.uint8: (2, 8), np.uint16: (512, 16), np.uint64: (1280, 64)}
  code, bitpix = codes[arr.dtype.type]
  hdr = bytearray(352)
  struct.pack_into("<i", hdr, 0, 348)
  struct.pack_into("<8h", hdr, 40, 3, *arr.shape, 1, 1, 1, 1)
  struct.pack_into("<hh", hdr, 70, code, bitpix)
  struct.pack_into("<f", hdr, 108, 352.0)
  hdr[344:348] = b"n+1\x00"
  blob = bytes(hdr) + np.asfortranarray(arr).tobytes(order="F")
  path.write_bytes(gzip.compress(blob, mtime=0) if path.name.endswith(".gz") else blob)


def _ingest_file(tmp_path, kind, arr):
  path = tmp_path / f"vol.{kind}"
  if kind == "npy":
    np.save(path, arr)
  elif kind == "npy.gz":
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    path.write_bytes(gzip.compress(buf.getvalue(), mtime=0))
  elif kind == "nrrd":
    _nrrd(path, arr, encoding="gzip")
  elif kind in ("nii", "nii.gz"):
    _nifti(path, arr)
  else:
    import h5py

    with h5py.File(path, "w") as f:
      f.create_dataset("other", data=np.zeros(3))
      f.create_dataset("main", data=arr)
  return path


@pytest.mark.parametrize("kind", ["npy", "npy.gz", "nrrd", "nii", "nii.gz", "h5"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint64])
def test_cli_image_create_matches_reference(tmp_path, kind, dtype):
  arr = image((70, 45, 19)).astype(dtype)
  if dtype == np.uint64:
    arr = arr * np.uint64(2**56) + np.uint64(3)
  src = _ingest_file(tmp_path, kind, arr)
  opts = ["--resolution", "4,4,40", "--offset", "5,6,7", "--chunk-size", "32,32,8"]
  if dtype == np.uint64:
    opts += ["--seg", "--encoding", "compressed_segmentation"]
  for side in ("jax", "port"):
    args = ["image", "create", str(src), f"file://{tmp_path / side / 'layer'}", *opts]
    if side == "jax":
      res = CliRunner().invoke(jax_cli, args)
      assert res.exit_code == 0, res.output
    else:
      assert cli_main(args) == 0
  assert tree(tmp_path / "port", "layer") == tree(tmp_path / "jax", "layer")
  np.testing.assert_array_equal(formats.load_volume_file(str(src)), arr)
  vol = JaxVolume(f"file://{tmp_path / 'port' / 'layer'}")
  np.testing.assert_array_equal(vol.download(vol.bounds)[..., 0], arr)


@pytest.mark.parametrize("name", ["vol.ckl", "vol.tif", "broken.npy.gz"])
def test_cli_image_create_refusals_match_reference(tmp_path, name):
  src = tmp_path / name
  src.write_bytes(b"\x1f\x8b not really gzip")
  args = ["image", "create", str(src), f"file://{tmp_path / 'layer'}"]
  res = CliRunner().invoke(jax_cli, args)
  assert res.exit_code == 2
  with pytest.raises(SystemExit) as err:
    cli_main(args)
  assert err.value.code == 2
  assert not (tmp_path / "layer").exists()


def test_hdf5_without_h5py_raises_as_the_reference(monkeypatch, tmp_path):
  monkeypatch.setitem(sys.modules, "h5py", None)
  errors = []
  for lib in (jax_formats, formats):
    with pytest.raises(ValueError) as err:
      lib.load_hdf5(str(tmp_path / "x.h5"))
    errors.append(str(err.value))
  assert errors[0] == errors[1]


def test_formats_module_equals_reference_readers(tmp_path):
  arr = image((20, 17, 9)).astype(np.uint16)
  for kind in ("npy", "npy.gz", "nrrd", "nii", "nii.gz"):
    src = str(_ingest_file(tmp_path, kind, arr))
    a, b = formats.load_volume_file(src), jax_formats.load_volume_file(src)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
