"""The layer-maintenance tasks and isotropic factors in the port, against
the JAX package.

``DeleteTask`` over mips, ``BlackoutTask`` aligned and with
``non_aligned_writes``, ``TouchTask`` (and its error on a missing chunk),
``QuantizeTask``, each factory's tasks (``create_deletion_tasks``,
``create_blackout_tasks``, ``create_touch_tasks``,
``create_quantized_affinity_info``, ``create_quantize_tasks``,
``create_fixup_downsample_tasks`` from boxes and from mip-0 points), the
``near_isotropic_factor_sequence`` planner and ``factor="isotropic"``
through tasks, info and bytes, and ``image rm`` and ``image downsample
--isotropic`` on both command lines. The same seeded layers go through
both packages, and every file is held byte for byte (the integrity
manifests as records without ``ts``, the provenance without its date).
"""

import json
import pathlib

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import downsample_scales as jax_scales
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu_torch import Bbox, Volume, chunk_cache, device, downsample_scales
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import BlackoutTask, DeleteTask, QuantizeTask, TouchTask
from igneous_tpu_torch.volume import EmptyVolumeError

from test_torch_integrity import flush_local, layer_tree

SHAPE = (301, 211, 20)
CHUNK = (32, 32, 16)


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


def image(shape, seed=0):
  rng = np.random.default_rng(seed)
  ramp = np.add.outer(np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])),
                      3 * np.arange(shape[2]))
  return np.asfortranarray(((ramp + rng.integers(0, 20, shape)) % 255).astype(np.uint8))


def _jax_queue():
  return JaxQueue(parallel=1, progress=False)


def _tree(root: pathlib.Path, name: str):
  """Every file of a layer (sidecars normalised) and its provenance
  without dates and roots."""
  flush_local()
  tree = layer_tree(root / name)
  prov = json.loads((root / name / "provenance").read_text())
  for entry in prov["processing"]:
    entry.pop("date")
  tree["provenance"] = json.loads(json.dumps(prov).replace(str(root), "ROOT"))
  return tree


def _params(tasks, root):
  return [json.loads(json.dumps(t.payload()["params"]).replace(str(root), "ROOT"))
          for t in tasks]


def _layers(tmp_path, data=None, mips=2, **kw):
  """tmp/{jax,port}/src, written by the JAX package with ``mips``
  downsampled scales."""
  data = image(SHAPE) if data is None else data
  roots = {}
  for side in ("jax", "port"):
    roots[side] = tmp_path / side
    path = f"file://{roots[side] / 'src'}"
    JaxVolume.from_numpy(data, path, resolution=(8, 8, 40), **dict(dict(chunk_size=CHUNK), **kw))
    if mips:
      _jax_queue().insert(jax_tc.create_downsampling_tasks(path, num_mips=mips))
  return roots


def _both(roots, make, name="src", run=True):
  """``make(lib, path)``'s tasks from each package's factory, run by its
  own queue; returns the payloads of each, with the roots taken out."""
  tasks = {}
  for side, root in roots.items():
    lib = jax_tc if side == "jax" else tc
    tasks[side] = list(make(lib, f"file://{root / name}", side))
    if run:
      (_jax_queue() if side == "jax" else LocalTaskQueue(parallel=1)).insert(tasks[side])
  assert _params(tasks["port"], roots["port"]) == _params(tasks["jax"], roots["jax"])
  return tasks


def _box(side, *pts):
  return (JaxBbox if side == "jax" else Bbox)(*pts)


# ---------------------------------------------------------------------------
# deletion

@pytest.mark.parametrize("kw", [
  dict(num_mips=1, box=((32, 64, 0), (200, 150, 20))),
  dict(num_mips=5, box=None, shape=(64, 64, 16)),
  dict(num_mips=0, mip=1, box=((0, 0, 0), (40, 100, 16)), shape=(32, 32, 16)),
], ids=["mips_0_1_box", "every_mip", "mip1_only"])
def test_deletion_tasks_match_reference(tmp_path, kw):
  roots = _layers(tmp_path)
  box = kw.pop("box")
  tasks = _both(roots, lambda lib, path, side: lib.create_deletion_tasks(
    path, bounds=None if box is None else _box(side, *box),
    bounds_mip=kw.get("mip", 0), **kw))
  assert all(type(t) is DeleteTask for t in tasks["port"])
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  if box is None:  # every chunk of every mip is gone
    assert not any(p.suffix == ".gz" for p in (roots["port"] / "src").rglob("*")
                   if "integrity" not in p.parts)


def test_delete_task_payload_from_reference_runs(tmp_path):
  roots = _layers(tmp_path, mips=1)
  jax_tasks = list(jax_tc.create_deletion_tasks(f"file://{roots['port'] / 'src'}",
                                                num_mips=1, shape=(64, 64, 16)))
  for t in jax_tasks:
    deserialize(jax_serialize(t)).execute()
  _jax_queue().insert(jax_tc.create_deletion_tasks(f"file://{roots['jax'] / 'src'}",
                                                   num_mips=1, shape=(64, 64, 16)))
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")


def test_cli_image_rm_matches_reference(tmp_path):
  roots = _layers(tmp_path)
  args = ["image", "rm", "file://ROOT/src", "--num-mips", "1", "--xrange", "0,128",
          "--shape", "64,64,16"]
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  # and through a queue
  spec = f"fq://{tmp_path / 'q'}"
  assert cli_main(["image", "rm", f"file://{roots['port'] / 'src'}", "--mip", "2",
                   "--queue", spec]) == 0
  assert cli_main(["execute", spec, "-x", "-q"]) == 0
  res = CliRunner().invoke(jax_cli, ["image", "rm", f"file://{roots['jax'] / 'src'}",
                                     "--mip", "2"])
  assert res.exit_code == 0, res.output
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")


# ---------------------------------------------------------------------------
# blackout, touch

@pytest.mark.parametrize("non_aligned", [False, True], ids=["aligned", "non_aligned"])
@pytest.mark.parametrize("encoding", ["raw", "compressed_segmentation"])
def test_blackout_tasks_match_reference(tmp_path, non_aligned, encoding):
  roots = _layers(tmp_path, mips=0, encoding=encoding)
  tasks = _both(roots, lambda lib, path, side: lib.create_blackout_tasks(
    path, _box(side, (10, 40, 3), (150, 100, 17)), shape=(64, 64, 16), value=7,
    non_aligned_writes=non_aligned))
  assert all(type(t) is BlackoutTask for t in tasks["port"])
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  got = Volume(f"file://{roots['port'] / 'src'}").download(Bbox((0, 0, 0), SHAPE))[..., 0]
  want = image(SHAPE)
  if non_aligned:
    want[10:150, 40:100, 3:17] = 7
  else:
    want[0:160, 32:128, 0:20] = 7
  np.testing.assert_array_equal(got, want)


def test_touch_tasks_match_reference_and_raise_on_a_missing_chunk(tmp_path):
  roots = _layers(tmp_path, mips=1)
  tasks = _both(roots, lambda lib, path, side: lib.create_touch_tasks(
    path, shape=(128, 128, 16)))
  assert all(type(t) is TouchTask for t in tasks["port"])
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  for side, root in roots.items():
    (root / "src" / "8_8_40" / "32-64_0-32_0-16.gz").unlink()
  with pytest.raises(Exception) as ref:
    for t in jax_tc.create_touch_tasks(f"file://{roots['jax'] / 'src'}", shape=(128, 128, 16)):
      t.execute()
  assert type(ref.value).__name__ == "EmptyVolumeError"
  with pytest.raises(EmptyVolumeError, match="32-64_0-32_0-16"):
    LocalTaskQueue(parallel=1).insert(tc.create_touch_tasks(
      f"file://{roots['port'] / 'src'}", shape=(128, 128, 16)))
  # the other mip is complete
  LocalTaskQueue(parallel=1).insert(tc.create_touch_tasks(
    f"file://{roots['port'] / 'src'}", mip=1, shape=(64, 64, 16)))


# ---------------------------------------------------------------------------
# quantize

def affinities(shape, seed=0):
  """float32 affinities in three channels, past [0, 1] on both sides, with
  values whose product with 255 lands exactly on an integer."""
  rng = np.random.default_rng(seed)
  aff = rng.uniform(-0.2, 1.2, tuple(shape) + (3,)).astype(np.float32)
  aff[:4, :4, :2, 0] = np.array([0.0, 1.0, 0.5, 1 / 255], np.float32)[:, None, None]
  return np.asfortranarray(aff)


@pytest.mark.parametrize("kw", [
  dict(shape=(128, 128, 64)),
  dict(shape=(128, 96, 16), chunk_size=(64, 32, 16), encoding="png", fill_missing=True,
       bounds=((0, 32, 0), (200, 211, 20))),
], ids=["default", "png_bounds"])
def test_quantize_tasks_match_reference(tmp_path, kw):
  data = affinities(SHAPE)
  roots = _layers(tmp_path, data=data, mips=0, layer_type="image")
  box = kw.pop("bounds", None)
  infos = [json.dumps(lib.create_quantized_affinity_info(
    f"file://{roots['port'] / 'src'}", "unused", kw["shape"], 0, (64, 64, 16)))
    for lib in (jax_tc, tc)]
  assert infos[0] == infos[1]
  tasks = {}
  for side, root in roots.items():
    lib = jax_tc if side == "jax" else tc
    tasks[side] = list(lib.create_quantize_tasks(
      f"file://{root / 'src'}", f"file://{root / 'dest'}",
      bounds=None if box is None else _box(side, *box), **kw))
    (_jax_queue() if side == "jax" else LocalTaskQueue(parallel=1)).insert(tasks[side])
  assert _params(tasks["port"], roots["port"]) == _params(tasks["jax"], roots["jax"])
  assert all(type(t) is QuantizeTask for t in tasks["port"])
  assert _tree(roots["port"], "dest") == _tree(roots["jax"], "dest")
  if box is None and "encoding" not in kw:
    got = Volume(f"file://{roots['port'] / 'dest'}").download(Bbox((0, 0, 0), SHAPE))[..., 0]
    np.testing.assert_array_equal(
      got, np.clip(data[..., 0].astype(np.float32) * 255.0, 0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# fixup

@pytest.mark.parametrize("form", ["boxes", "points", "both"])
def test_fixup_downsample_tasks_match_reference(tmp_path, form):
  roots = _layers(tmp_path, mips=2)
  for root in roots.values():  # the damage: chunks of mips 1 and 2 gone
    for name in ("16_16_40/32-64_64-96_0-16.gz", "32_32_40/0-32_32-53_0-16.gz"):
      (root / "src" / name).unlink()

  def make(lib, path, side):
    kw = dict(mip=0, shape=(128, 128, 16), num_mips=2)
    if form in ("boxes", "both"):
      kw["bad_bboxes"] = [_box(side, (70, 130, 0), (90, 190, 16)),
                          _box(side, (0, 0, 0), (1, 1, 1))]
    if form in ("points", "both"):
      kw["points"] = [(75, 140, 3), (260, 200, 19), (75, 141, 3)]
    return lib.create_fixup_downsample_tasks(path, **kw)

  tasks = _both(roots, make)
  assert len(tasks["port"]) == {"boxes": 2, "points": 2, "both": 3}[form]
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  assert (roots["port"] / "src" / "16_16_40" / "32-64_64-96_0-16.gz").exists()
  ratio_points = list(tc.create_fixup_downsample_tasks(
    f"file://{roots['port'] / 'src'}", mip=1, points=[(260, 200, 19)], shape=(64, 64, 16),
    axis="x"))
  assert [t.payload()["params"]["offset"] for t in ratio_points] == [[128, 64, 16]]
  assert ratio_points[0].payload()["params"]["factor"] == [1, 2, 2]


# ---------------------------------------------------------------------------
# isotropic factors

@pytest.mark.parametrize("res", [(8, 8, 40), (4, 4, 40), (1, 1, 1), (40, 8, 8), (7, 3, 11),
                                 (16, 16, 17), (5, 9, 31)])
def test_near_isotropic_factor_sequence_matches_reference(res):
  for n in (0, 1, 5, 9):
    assert downsample_scales.near_isotropic_factor_sequence(res, n) == \
      jax_scales.near_isotropic_factor_sequence(res, n)
  assert downsample_scales.near_isotropic_factor_sequence((8, 8, 40), 5) == \
    [(2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)]


@pytest.mark.parametrize("kw", [
  dict(num_mips=5),
  dict(num_mips=3, memory_target=int(2e6), chunk_size=(16, 16, 16), mip=1),
], ids=["default", "memory_mip1"])
def test_isotropic_downsample_matches_reference(tmp_path, kw):
  roots = _layers(tmp_path, data=image((256, 256, 64)), mips=1 if kw.get("mip") else 0,
                  chunk_size=(32, 32, 32))
  tasks = _both(roots, lambda lib, path, side: lib.create_downsampling_tasks(
    path, factor="isotropic", **kw))
  assert _tree(roots["port"], "src") == _tree(roots["jax"], "src")
  factors = tasks["port"][0].payload()["params"]["factor"]
  assert factors[0] == [2, 2, 1] and [2, 2, 2] in factors
  with pytest.raises(ValueError, match="unknown factor spec"):
    tc.create_downsampling_tasks(f"file://{roots['port'] / 'src'}", factor="anisotropic")


def test_cli_isotropic_matches_reference(tmp_path):
  roots = _layers(tmp_path, data=image((128, 128, 64)), mips=0, chunk_size=(32, 32, 32))
  args = ["image", "downsample", "file://ROOT/src", "--isotropic", "--num-mips", "3"]
  res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
  assert res.exit_code == 0, res.output
  assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  tree = _tree(roots["port"], "src")
  assert tree == _tree(roots["jax"], "src")
  keys = [s["key"] for s in Volume(f"file://{roots['port'] / 'src'}").info["scales"]]
  assert keys == ["8_8_40", "16_16_40", "32_32_40", "64_64_80"]
