"""The port's 4-pass connected-components slice against the JAX package.

ccl_auto(encoding="raw") in both packages on the same layers: byte-identical
destination chunks, equal info and max_label, byte-identical scratch files
(faces, equivalences, relabel maps); payloads the JAX package serialized
run in the port; the command lines agree; at the default
compressed_segmentation destination, ccl_auto, the pass-4 factory and the
command line write the reference's bytes too.
"""

import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.storage import CloudFiles as JaxCloudFiles
from igneous_tpu.storage import scratch_gzip_level as jax_scratch_gzip_level
from igneous_tpu_torch import Bbox, CloudFiles, Volume, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.storage import scratch_gzip_level
from igneous_tpu_torch.tasks import CCLFacesTask


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the reference's CPU default: its native two-pass union-find
  monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  monkeypatch.delenv("IGNEOUS_SCRATCH_COMPRESS", raising=False)
  monkeypatch.delenv("IGNEOUS_CCL_TILE", raising=False)
  device.reset_device()
  yield
  device.reset_device()


def checkerboard(shape, cell):
  grid = (np.indices(shape) // cell).sum(axis=0)
  return (grid % 2 == 0).astype(np.uint8)


def _files(root: pathlib.Path):
  return {
    str(p.relative_to(root)): p.read_bytes()
    for p in sorted(root.rglob("*")) if p.is_file()
  }


def _chunks(root: pathlib.Path):
  """Every file of a layer but its provenance (which records a date)."""
  return {k: v for k, v in _files(root).items() if k != "provenance"}


def _source(tmp_path, name, data, **kw):
  path = tmp_path / name
  JaxVolume.from_numpy(data, f"file://{path}", **kw)
  return path


LAYERS = {
  "checkerboard_threshold": (
    lambda rng: checkerboard((70, 52, 30), 9), dict(layer_type="image"),
    dict(shape=(32, 32, 32), threshold_gte=1),
  ),
  "multilabel_dust": (
    lambda rng: (rng.integers(0, 4, (60, 50, 24)) * 3).astype(np.uint32),
    dict(layer_type="segmentation", chunk_size=(16, 16, 16)),
    dict(shape=(32, 32, 16), dust_threshold=3),
  ),
  "uint64_unaligned_bounds": (
    lambda rng: ((rng.random((50, 40, 20)) < 0.3) * np.uint64(2**40 + 5)).astype(np.uint64),
    dict(layer_type="segmentation", chunk_size=(16, 16, 16)),
    dict(shape=(16, 16, 16), bounds=((1, 1, 1), (33, 33, 19))),
  ),
}


def _run_both(tmp_path, name, clean=True):
  """ccl_auto over one layer in each package; returns the two roots."""
  make, vol_kw, auto_kw = LAYERS[name]
  data = make(np.random.default_rng(7))
  roots = {}
  for pkg in ("jax", "torch"):
    src = _source(tmp_path / pkg, "src", data, **vol_kw)
    kw = dict(auto_kw)
    bounds = kw.pop("bounds", None)
    run = jax_tc.ccl_auto if pkg == "jax" else tc.ccl_auto
    if bounds is not None:
      kw["bounds"] = (JaxBbox if pkg == "jax" else Bbox)(*bounds)
    roots[pkg] = (run(
      f"file://{src}", f"file://{tmp_path / pkg / 'dest'}", encoding="raw",
      clean=clean, **kw,
    ), tmp_path / pkg)
  return roots


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_ccl_auto_matches_reference(tmp_path, name):
  roots = _run_both(tmp_path, name)
  (jax_n, jax_root), (torch_n, torch_root) = roots["jax"], roots["torch"]
  assert torch_n == jax_n > 0
  want = _chunks(jax_root / "dest")
  got = _chunks(torch_root / "dest")
  assert sorted(got) == sorted(want)
  assert got == want
  assert Volume(f"file://{torch_root / 'dest'}").meta.info == \
    JaxVolume(f"file://{jax_root / 'dest'}").meta.info
  # clean=True deletes the scratch files in both
  assert list(CloudFiles(f"file://{torch_root / 'src'}").list("ccl/")) == []


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_scratch_files_match_reference(tmp_path, name):
  roots = _run_both(tmp_path, name, clean=False)
  want = _files(roots["jax"][1] / "src" / "ccl")
  got = _files(roots["torch"][1] / "src" / "ccl")
  kinds = {k.split("/")[1] for k in got}
  assert kinds == {"faces", "equivalences", "relabel", "max_label.json"}
  assert sorted(got) == sorted(want)
  assert got == want


def test_destination_matches_an_independent_oracle(tmp_path):
  from scipy import ndimage

  data = checkerboard((70, 52, 30), 9)
  src = _source(tmp_path, "src", data, layer_type="image")
  n = tc.ccl_auto(f"file://{src}", f"file://{tmp_path / 'dest'}",
                  shape=(32, 32, 32), threshold_gte=1, encoding="raw")
  exp, en = ndimage.label(data, structure=ndimage.generate_binary_structure(3, 1))
  vol = Volume(f"file://{tmp_path / 'dest'}")
  out = vol.download(vol.mip_bounds(0))[..., 0]
  assert n == en
  pairs = np.unique(np.stack([out.ravel(), exp.ravel()]), axis=1)
  assert len(np.unique(pairs[0])) == len(np.unique(pairs[1])) == pairs.shape[1]


def test_scratch_gzip_level_follows_the_reference(monkeypatch):
  for val in ("", "gzip", "gzip-1", "gzip-9", "none", "zstd"):
    monkeypatch.setenv("IGNEOUS_SCRATCH_COMPRESS", val)
    assert scratch_gzip_level(4) == jax_scratch_gzip_level(4), val
  monkeypatch.setenv("IGNEOUS_SCRATCH_COMPRESS", "brotli")
  with pytest.raises(ValueError):
    scratch_gzip_level(4)


@pytest.mark.parametrize("protocol", ["file", "mem"])
def test_cloudfiles_list_matches_reference(tmp_path, protocol):
  def root(pkg):
    if protocol == "file":
      return f"file://{tmp_path}/{pkg}"
    return f"mem://list-{tmp_path.name}-{pkg}"

  ours, theirs = CloudFiles(root("torch")), JaxCloudFiles(root("jax"))
  for cf in (ours, theirs):
    cf.put("ccl/0/faces/1-x.npy.gz", b"a")
    cf.put("ccl/0/equivalences/10.json", b"{}")
    cf.put("ccl/0/equivalences/2.json", b"{}", compress="gzip")
    cf.put("ccl/01/x.json", b"{}")
    cf.put("info", b"{}")
  for prefix in ("", "ccl/", "ccl/0/", "ccl/0/equivalences/", "ccl/0/eq", "nope/"):
    assert list(ours.list(prefix)) == list(theirs.list(prefix)), prefix
  for cf in (ours, theirs):
    cf.delete(list(cf.list("ccl/0/")))
  assert sorted(ours.list("")) == sorted(theirs.list("")) == ["ccl/01/x.json", "info"]


def test_reference_payloads_run_in_the_port(tmp_path):
  """Pass-1 and pass-2 payloads serialized by the JAX package write the
  reference's scratch files when the port executes them."""
  data = (np.random.default_rng(3).random((40, 36, 20)) < 0.4).astype(np.uint8)
  outs = {}
  for pkg in ("jax", "torch"):
    src = _source(tmp_path / pkg, "src", data, layer_type="image", chunk_size=(16, 16, 16))
    for factory in (jax_tc.create_ccl_face_tasks, jax_tc.create_ccl_equivalence_tasks):
      tasks = list(factory(f"file://{src}", 0, (32, 32, 16), threshold_gte=1))
      assert len(tasks) == 8  # a 2 x 2 x 2 grid
      for task in tasks:
        payload = jax_serialize(task)
        if pkg == "jax":
          task.execute()
        else:
          ported = deserialize(payload)
          assert type(ported).__module__.startswith("igneous_tpu_torch")
          ported.execute()
    outs[pkg] = _files(src / "ccl")
  assert outs["torch"] == outs["jax"] and outs["jax"]
  face = next(iter(jax_tc.create_ccl_face_tasks(f"file://{src}", 0, (32, 32, 16))))
  ported = deserialize(jax_serialize(face))
  assert type(ported) is CCLFacesTask
  assert ported._params == face._params


def test_cli_ccl_auto_matches_reference(tmp_path):
  data = checkerboard((50, 40, 20), 7)
  args = ["--shape", "32,32,16", "--threshold-gte", "1", "--encoding", "raw"]
  jsrc = _source(tmp_path / "jax", "src", data, layer_type="image", chunk_size=(16, 16, 16))
  res = CliRunner().invoke(
    jax_cli, ["image", "ccl", "auto", f"file://{jsrc}", f"file://{tmp_path / 'jax' / 'dest'}", *args]
  )
  assert res.exit_code == 0, res.output
  tsrc = _source(tmp_path / "torch", "src", data, layer_type="image", chunk_size=(16, 16, 16))
  assert cli_main(["image", "ccl", "auto", str(tsrc), f"file://{tmp_path / 'torch' / 'dest'}", *args]) == 0
  assert _chunks(tmp_path / "torch" / "dest") == _chunks(tmp_path / "jax" / "dest")


def test_cli_passes_one_by_one_match_auto(tmp_path, capsys):
  data = (np.random.default_rng(4).integers(0, 3, (40, 36, 20)) * 5).astype(np.uint32)
  opts = ["--shape", "16,16,16", "--dust", "2"]
  srcs = {}
  for how in ("auto", "passes"):
    srcs[how] = _source(tmp_path / how, "src", data, layer_type="segmentation",
                        chunk_size=(16, 16, 16))
  dest = {how: f"file://{tmp_path / how / 'dest'}" for how in srcs}
  assert cli_main(["image", "ccl", "auto", str(srcs["auto"]), dest["auto"],
                   "--encoding", "raw", *opts]) == 0
  src = str(srcs["passes"])
  assert cli_main(["image", "ccl", "faces", src, *opts]) == 0
  assert cli_main(["image", "ccl", "links", src, *opts]) == 0
  assert cli_main(["image", "ccl", "calc-labels", src]) == 0
  assert cli_main(["image", "ccl", "relabel", src, dest["passes"], "--encoding", "raw", *opts]) == 0
  assert list(CloudFiles(src).list("ccl/"))
  assert cli_main(["image", "ccl", "clean", src]) == 0
  assert list(CloudFiles(src).list("ccl/")) == []
  out = capsys.readouterr().out
  assert "max_label:" in out and "components:" in out
  assert _chunks(tmp_path / "passes" / "dest") == _chunks(tmp_path / "auto" / "dest")


def _default_encoding_layer(tmp_path, who):
  data = checkerboard((40, 36, 20), 7)
  return _source(tmp_path / who, "src", data, layer_type="image", chunk_size=(16, 16, 16))


def test_ccl_auto_default_cseg_matches_reference(tmp_path):
  """ccl_auto's default destination, compressed_segmentation."""
  counts = {}
  for who, run in (("jax", jax_tc.ccl_auto), ("torch", tc.ccl_auto)):
    src = _default_encoding_layer(tmp_path, who)
    counts[who] = run(f"file://{src}", f"file://{tmp_path / who / 'dest'}",
                      shape=(16, 16, 16), threshold_gte=1)
  assert counts["torch"] == counts["jax"] > 1
  got, want = _chunks(tmp_path / "torch" / "dest"), _chunks(tmp_path / "jax" / "dest")
  assert len(got) > 4 and got == want
  info = Volume(f"file://{tmp_path / 'torch' / 'dest'}").meta.info
  assert info["scales"][0]["encoding"] == "compressed_segmentation"
  assert info["scales"][0]["compressed_segmentation_block_size"] == [8, 8, 8]


def test_relabel_factory_default_cseg_matches_reference(tmp_path):
  """Passes 1-3, then create_ccl_relabel_tasks at its default encoding."""
  for who, lib, queue in (("jax", jax_tc, None), ("torch", tc, LocalTaskQueue())):
    src = f"file://{_default_encoding_layer(tmp_path, who)}"
    kw = dict(threshold_gte=1)
    for factory in (lib.create_ccl_face_tasks, lib.create_ccl_equivalence_tasks):
      tasks = factory(src, 0, (16, 16, 16), **kw)
      if queue is None:
        for task in tasks:
          task.execute()
      else:
        queue.insert(tasks)
    lib.create_relabeling(src, 0)
    tasks = lib.create_ccl_relabel_tasks(src, f"file://{tmp_path / who / 'dest'}", 0,
                                         (16, 16, 16), **kw)
    if queue is None:
      for task in tasks:
        task.execute()
    else:
      queue.insert(tasks)
  got, want = _chunks(tmp_path / "torch" / "dest"), _chunks(tmp_path / "jax" / "dest")
  assert len(got) > 4 and got == want
  assert _files(tmp_path / "torch" / "src" / "ccl") == _files(tmp_path / "jax" / "src" / "ccl")


def test_cli_ccl_auto_default_cseg_matches_reference(tmp_path):
  args = ["--shape", "16,16,16", "--threshold-gte", "1"]
  jsrc = _default_encoding_layer(tmp_path, "jax")
  res = CliRunner().invoke(
    jax_cli, ["image", "ccl", "auto", f"file://{jsrc}", f"file://{tmp_path / 'jax' / 'dest'}", *args]
  )
  assert res.exit_code == 0, res.output
  tsrc = _default_encoding_layer(tmp_path, "torch")
  assert cli_main(["image", "ccl", "auto", str(tsrc), f"file://{tmp_path / 'torch' / 'dest'}", *args]) == 0
  got, want = _chunks(tmp_path / "torch" / "dest"), _chunks(tmp_path / "jax" / "dest")
  assert len(got) > 4 and got == want
  assert b"compressed_segmentation" in got["info"]
