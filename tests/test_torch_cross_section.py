"""The port's cross-sectional areas, DBSCAN, compressed labels and SWC
against the JAX package.

Both packages build ``xsection.cpp`` from the same source with the same
g++ flags, so the library's areas are the same bits; the port's library is
also held against its numpy twin within the JAX package's own bound
(``abs(native - py) <= 1e-9 * max(1, py)``, ``tests/test_skeleton.py``).
``cross_sectional_area`` (smoothing windows 1 and 3, a vertex mask, a
clipped window) returns the same float32 arrays; ``SkeletonTask`` with
``cross_sectional_area`` (``low_memory_csa`` on and off, the contact
repair unlimited (-1) and off (0)) writes the same fragments, spatial
files and merged skeletons; a positive repair budget is wall-clock time
in both packages, so only the repaired/unrepaired flags are compared.
``to_swc`` text, ``from_swc`` round trips and ``skeleton convert`` files
are equal. Exact everywhere else.
"""

import numpy as np
import pytest
from click.testing import CliRunner

from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.compressed import CompressedLabels as JaxCompressedLabels
from igneous_tpu.ops import cross_section as jax_cs
from igneous_tpu.ops.dbscan import dbscan as jax_dbscan
from igneous_tpu.ops.remap import label_bboxes as jax_label_bboxes
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.skeleton_io import Skeleton as JaxSkeleton
from igneous_tpu.skeleton_io import from_swc as jax_from_swc
from igneous_tpu.skeleton_io import to_swc as jax_to_swc
from igneous_tpu_torch import device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.compressed import CompressedLabels
from igneous_tpu_torch.ops import cross_section as cs
from igneous_tpu_torch.ops.dbscan import dbscan
from igneous_tpu_torch.ops.mesh import label_bboxes
from igneous_tpu_torch.queues import LocalTaskQueue
from igneous_tpu_torch.skeleton_io import Skeleton, from_swc, to_swc
from igneous_tpu_torch.tasks import SkeletonTask

from test_torch_skeleton_tasks import FORGE, MERGE, _files, _layers, _skel_files, tubes


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.delenv("IGNEOUS_TPU_NO_NATIVE", raising=False)
  device.reset_device()
  yield
  device.reset_device()


def _planes(seed, n):
  rng = np.random.default_rng(seed)
  for _ in range(n):
    k = int(rng.integers(1, 30))
    vox = rng.integers(-4, 24, (k, 3)).astype(np.int64)
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    yield vox, rng.uniform(-10, 300, 3), t, rng.uniform(1.0, 40.0, 3)


@pytest.mark.parametrize("seed", [7, 11])
def test_xsection_library_matches_its_numpy_twin_and_the_reference(seed):
  for vox, v, t, anis in _planes(seed, 80):
    native = cs._plane_cube_areas(vox, v, t, anis)
    py = cs._plane_cube_areas_py(vox, v, t, anis)
    assert abs(native - py) <= 1e-9 * max(1.0, py)
    assert np.float64(native).tobytes() == np.float64(
      jax_cs._plane_cube_areas(vox, v, t, anis)).tobytes()
    assert py == jax_cs._plane_cube_areas_py(vox, v, t, anis)


def test_xsection_library_raises_when_it_does_not_build(monkeypatch):
  from igneous_tpu_torch.ops import _build

  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "library_path", lambda name: _build.BUILD_DIR / "absent.so")
  monkeypatch.setattr(_build, "_source", lambda name: (
    _build.CSRC_DIR / "xsection.cpp", ["-DNOT_A_FLAG", "-x", "not-a-language"],
    lambda: "g++"))
  with pytest.raises(RuntimeError, match="failed"):
    cs.xsection_lib()


def _tube_skeleton(mod, seed):
  """A thick tube and a skeleton along its centerline, with a kink."""
  rng = np.random.default_rng(seed)
  mask = np.zeros((40, 36, 30), bool)
  g = np.stack(np.meshgrid(*[np.arange(s) for s in mask.shape], indexing="ij"), -1)
  a, b = np.array([2.0, 8, 6]), np.array([37.0, 26, 22])
  d = b - a
  t = np.clip(((g - a) @ d) / (d @ d), 0, 1)
  mask[np.linalg.norm(g - (a + t[..., None] * d), axis=-1) <= rng.uniform(3, 6)] = True
  n = 12
  pts = a + np.linspace(0, 1, n)[:, None] * d + rng.normal(0, 0.6, (n, 3))
  anis = np.array([4.0, 4.0, 10.0], np.float32)
  verts = (pts * anis).astype(np.float32)
  edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.uint32)
  return mask, mod(verts, edges), tuple(float(v) for v in anis)


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("clip", [False, True])
def test_cross_sectional_area_matches_reference(window, clip):
  mask, skel, anis = _tube_skeleton(Skeleton, 3)
  _, jskel, _ = _tube_skeleton(JaxSkeleton, 3)
  kw = dict(anisotropy=anis, offset=(1.0, -2.0, 0.5), smoothing_window=window)
  if clip:
    # a small window clips the slices (negative areas), a vertex mask
    # leaves the others at -1
    vmask = np.arange(len(skel.vertices)) % 2 == 0
    kw.update(window=4, vertex_mask=vmask)
  got = cs.cross_sectional_area(mask, skel, **kw)
  ref = jax_cs.cross_sectional_area(mask, jskel, **kw)
  assert got.dtype == ref.dtype == np.float32
  assert got.tobytes() == ref.tobytes()
  # clean slices, or clipped ones (negative, not the -1 of a skipped vertex)
  assert ((got < 0) & (got != -1)).any() if clip else (got > 0).any()
  assert np.array_equal(cs.vertex_tangents(skel, window), jax_cs.vertex_tangents(jskel, window))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_matches_reference(seed):
  rng = np.random.default_rng(seed)
  pts = np.concatenate([rng.normal(c, 3.0, (40, 3)) for c in rng.uniform(0, 60, (5, 3))])
  for eps, k in ((2.0, 1), (4.0, 3), (8.0, 5)):
    assert np.array_equal(dbscan(pts, eps, k), jax_dbscan(pts, eps, k))
  assert len(dbscan(np.zeros((0, 3)), 1.0)) == 0


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_compressed_labels_and_boxes_match_reference(dtype):
  data = tubes(dtype=dtype)
  boxes = label_bboxes(data)
  assert boxes == jax_label_bboxes(data)
  got, ref = CompressedLabels(data), JaxCompressedLabels(data)
  assert got.labels() == ref.labels() and got.nbytes == ref.nbytes
  assert np.array_equal(got.decompress(), data)
  assert np.array_equal(got.region((3, 5, 2), (40, 30, 20)), ref.region((3, 5, 2), (40, 30, 20)))
  for (la, ma, lo_a), (lb, mb, lo_b) in zip(got.each(), ref.each()):
    assert la == lb and lo_a == lo_b and np.array_equal(ma, mb)
  label = got.labels()[1]
  (mask, lo), (rmask, rlo) = got.mask(label, margin=1), ref.mask(label, margin=1)
  assert lo == rlo and np.array_equal(mask, rmask) and got.mask(12345) is None


CSA = {
  "window_1": dict(cross_sectional_area=True),
  "window_3": dict(cross_sectional_area=True, csa_smoothing_window=3),
  "low_memory": dict(cross_sectional_area=True, low_memory_csa=True),
  "no_repair": dict(cross_sectional_area=True, csa_repair_sec_per_label=0),
  "low_memory_no_repair_window_3": dict(
    cross_sectional_area=True, low_memory_csa=True, csa_repair_sec_per_label=0,
    cross_sectional_area_smoothing_window=3),
  "fill_holes": dict(cross_sectional_area=True, fill_holes=1),
}


def _forge(paths, task, **kw):
  kw = {**FORGE, **kw}
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_skeletonizing_tasks(f"file://{paths['jax']}", shape=task, **kw))
  LocalTaskQueue().insert(tc.create_skeletonizing_tasks(
    f"file://{paths['port']}", shape=task, **kw))


def _merge(paths):
  JaxQueue(parallel=1, progress=False).insert(
    jax_tc.create_unsharded_skeleton_merge_tasks(f"file://{paths['jax']}", **MERGE))
  LocalTaskQueue().insert(tc.create_unsharded_skeleton_merge_tasks(
    f"file://{paths['port']}", **MERGE))


def _areas(root, info_attrs):
  out = {}
  for k, v in _skel_files(root).items():
    if k.endswith(".sk.gz"):
      import gzip

      s = Skeleton.from_precomputed(gzip.decompress(v), vertex_attributes=info_attrs)
      out[k] = s.extra_attributes["cross_sectional_area"]
  return out


@pytest.mark.parametrize("case", sorted(CSA))
def test_cross_section_forge_and_merge_match_reference(case, tmp_path):
  paths = _layers(tmp_path, tubes())
  _forge(paths, (32, 24, 24), **CSA[case])
  _merge(paths)
  ref, got = _skel_files(paths["jax"]), _skel_files(paths["port"])
  assert sorted(got) == sorted(ref)
  assert [k for k in ref if got[k] != ref[k]] == []
  assert _files(paths["port"])["info"] == _files(paths["jax"])["info"]
  import json

  info = json.loads(got["skeletons_mip_0/info"])
  assert info["vertex_attributes"][-1]["id"] == "cross_sectional_area"
  areas = np.concatenate(list(_areas(paths["port"], info["vertex_attributes"]).values()))
  assert (areas > 0).any()
  if CSA[case].get("csa_repair_sec_per_label") == 0:
    assert (areas < 0).any()  # task-boundary slices stay clipped


def test_cross_section_positive_budget_flags_match_reference(tmp_path):
  """A positive budget is wall-clock seconds a label in both packages: the
  fragments hold the same repaired (positive) and unrepaired flags."""
  paths = _layers(tmp_path, tubes())
  _forge(paths, (32, 24, 24), cross_sectional_area=True, csa_repair_sec_per_label=600)
  import json

  info = json.loads(_skel_files(paths["port"])["skeletons_mip_0/info"])
  got = _areas(paths["port"], info["vertex_attributes"])
  ref = _areas(paths["jax"], info["vertex_attributes"])
  assert sorted(got) == sorted(ref)
  for k in ref:
    assert np.array_equal(got[k] > 0, ref[k] > 0)
    assert np.array_equal(got[k] == -1.0, ref[k] == -1.0)


def test_cli_cross_section_matches_reference(tmp_path):
  paths = _layers(tmp_path, tubes())
  args = ["skeleton", "forge", "--shape", "32,24,24", "--dust-threshold", "40",
          "--const", "80", "--scale", "4", "--cross-section", "3",
          "--cross-section-label-repair-sec", "-1", "--progress"]
  res = CliRunner().invoke(jax_cli, [*args[:2], f"file://{paths['jax']}", *args[2:]])
  assert res.exit_code == 0, res.output
  assert cli_main([*args[:2], f"file://{paths['port']}", *args[2:]]) == 0
  ref, got = _skel_files(paths["jax"]), _skel_files(paths["port"])
  assert sorted(got) == sorted(ref) and [k for k in ref if got[k] != ref[k]] == []


@pytest.mark.parametrize("kwargs", [{}, dict(cross_sectional_area=True)])
def test_swc_text_and_round_trip_match_reference(kwargs, tmp_path):
  paths = _layers(tmp_path, tubes())
  _forge(paths, (32, 24, 24), **kwargs)
  _merge(paths)
  import gzip
  import json

  info = json.loads(_skel_files(paths["port"])["skeletons_mip_0/info"])
  attrs = info["vertex_attributes"]
  finished = {k: v for k, v in _skel_files(paths["port"]).items()
              if k.split("/")[-1].split(".")[0].isdigit() and ":" not in k}
  assert finished
  for key, blob in finished.items():
    label = int(key.split("/")[-1].split(".")[0])
    raw = gzip.decompress(blob)
    s = Skeleton.from_precomputed(raw, vertex_attributes=attrs)
    js = JaxSkeleton.from_precomputed(raw, vertex_attributes=attrs)
    text = to_swc(s, label=label)
    assert text == jax_to_swc(js, label=label)
    back, jback = from_swc(text), jax_from_swc(text)
    assert np.array_equal(back.vertices, jback.vertices)
    assert np.array_equal(back.edges, jback.edges)
    assert np.array_equal(back.radii, jback.radii)
    assert np.array_equal(back.vertex_types, jback.vertex_types)
    assert to_swc(back) == jax_to_swc(jback)
  # skeleton convert: the same .swc files, --labels honoured
  out_p, out_j = tmp_path / "swc_port", tmp_path / "swc_jax"
  assert cli_main(["skeleton", "convert", f"file://{paths['port']}", str(out_p)]) == 0
  res = CliRunner().invoke(jax_cli, ["skeleton", "convert", f"file://{paths['jax']}", str(out_j)])
  assert res.exit_code == 0, res.output
  files = sorted(p.name for p in out_p.iterdir())
  assert files == sorted(p.name for p in out_j.iterdir()) and len(files) == len(finished)
  for name in files:
    assert (out_p / name).read_text() == (out_j / name).read_text()
  one = files[0].split(".")[0]
  assert cli_main(["skeleton", "convert", f"file://{paths['port']}",
                   str(tmp_path / "one"), "--labels", one]) == 0
  assert [p.name for p in (tmp_path / "one").iterdir()] == [files[0]]


def test_cross_section_task_payload_runs_in_the_port(tmp_path):
  """A payload the JAX package serialized, with the cross-section options,
  runs in the port and writes the JAX package's fragments."""
  from igneous_tpu.queues.registry import serialize as jax_serialize
  from igneous_tpu_torch.queues import deserialize

  paths = _layers(tmp_path, tubes())
  kw = dict(FORGE, cross_sectional_area=True, csa_smoothing_window=3, shape=(32, 24, 24))
  jax_tasks = list(jax_tc.create_skeletonizing_tasks(f"file://{paths['jax']}", **kw))
  list(tc.create_skeletonizing_tasks(f"file://{paths['port']}", **kw))
  JaxQueue(parallel=1, progress=False).insert(jax_tasks)
  for t in jax_tasks:
    task = deserialize(jax_serialize(t).replace(str(paths["jax"]), str(paths["port"])))
    assert isinstance(task, SkeletonTask) and task.cross_sectional_area
    task.execute()
  ref, got = _skel_files(paths["jax"]), _skel_files(paths["port"])
  assert sorted(got) == sorted(ref) and [k for k in ref if got[k] != ref[k]] == []
