"""Contrast correction in the port, against the JAX package.

``LuminanceLevelsTask``, ``ContrastNormalizationTask`` and ``CLAHETask``
through both packages' factories and ``LocalTaskQueue`` (and ``image
contrast histogram|equalize|clahe`` on both command lines), on the same
seeded layers: levels files, chunks, info, integrity records and
provenance byte for byte. ``clahe_plain`` (the plain version of the port's
``clahe`` kernel, which runs on the CPU) against OpenCV's
``CLAHE::apply``, which the JAX package's ``CLAHETask`` calls, bit for bit
on uint8 and uint16 planes, grids as an int and as a pair, clip limits 0,
2 and 40, planes where one axis divides by the grid and the other does
not, and planes smaller than the grid. The tolerance is bitwise throughout.
"""

import json
import pathlib

import cv2
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.lib import Bbox as JaxBbox
from igneous_tpu.queues import LocalTaskQueue as JaxQueue
from igneous_tpu.queues.registry import serialize as jax_serialize
from igneous_tpu.tasks.contrast import CLAHETask as JaxCLAHETask
from igneous_tpu_torch import Bbox, chunk_cache, device
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.ops import cuda_clahe
from igneous_tpu_torch.ops.clahe import clahe, clahe_plain
from igneous_tpu_torch.queues import LocalTaskQueue, deserialize
from igneous_tpu_torch.tasks import CLAHETask, ContrastNormalizationTask, LuminanceLevelsTask

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


def image(shape, dtype=np.uint8, seed=0):
  """A seeded ramp with noise: smooth enough for the tiles to differ, noisy
  enough for the clip to bite."""
  rng = np.random.default_rng(seed)
  hi = np.iinfo(dtype).max
  ramp = np.add.outer(np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1])),
                      3 * np.arange(shape[2])).astype(np.float64)
  vals = (ramp / ramp.max() * 0.6 + rng.random(shape) * 0.4) * hi
  return np.asfortranarray(vals.astype(dtype))


def _jax_queue():
  return JaxQueue(parallel=1, progress=False)


def tree(root: pathlib.Path, name: str):
  """Every file of a layer (sidecars normalised) and its provenance
  without dates and roots."""
  flush_local()
  files = layer_tree(root / name)
  prov = json.loads((root / name / "provenance").read_text())
  for entry in prov["processing"]:
    entry.pop("date")
  files["provenance"] = json.loads(json.dumps(prov).replace(str(root), "ROOT"))
  return files


def params(tasks, root):
  return [json.loads(json.dumps(t.payload()["params"]).replace(str(root), "ROOT"))
          for t in tasks]


def layers(tmp_path, data, **kw):
  """tmp/{jax,port}/src, written by the JAX package."""
  roots = {}
  for side in ("jax", "port"):
    roots[side] = tmp_path / side
    JaxVolume.from_numpy(data, f"file://{roots[side] / 'src'}", resolution=(8, 8, 40),
                         **dict(dict(chunk_size=CHUNK), **kw))
  return roots


def both(roots, make, name="src"):
  """``make(lib, path, side)``'s tasks from each package's factory, each run
  by its own queue; the payloads must be equal, roots taken out."""
  tasks = {}
  for side, root in roots.items():
    lib = jax_tc if side == "jax" else tc
    tasks[side] = list(make(lib, f"file://{root / name}", side))
    (_jax_queue() if side == "jax" else LocalTaskQueue(parallel=1)).insert(tasks[side])
  assert params(tasks["port"], roots["port"]) == params(tasks["jax"], roots["jax"])
  return tasks


def box(side, *pts):
  return (JaxBbox if side == "jax" else Bbox)(*pts)


# ---------------------------------------------------------------------------
# the plain version against OpenCV


def _planes(shape, dtype, seed):
  rng = np.random.default_rng(seed)
  hi = int(np.iinfo(dtype).max) + 1
  r, c, p = shape
  base = np.add.outer(np.arange(r), 3 * np.arange(c))[:, :, None] * (hi // 512 or 1)
  vals = (base + rng.integers(0, hi // 4, shape)) % hi
  if seed % 3 == 0:
    vals = rng.integers(0, hi, shape)
  return np.asfortranarray(vals.astype(dtype))


CASES = [
  # (rows, cols, planes), dtype, grid, clip
  ((64, 64, 2), np.uint8, 8, 40.0),  # both axes divide: no pad
  ((70, 64, 2), np.uint8, 8, 40.0),  # rows do not divide, columns do
  ((64, 70, 2), np.uint8, 8, 2.0),  # columns do not divide, rows do
  ((97, 131, 3), np.uint8, (4, 8), 40.0),  # a pair: 4 across columns, 8 across rows
  ((131, 97, 2), np.uint8, (4, 8), 0.0),  # no clip
  ((50, 40, 2), np.uint8, (8, 8), 2.0),  # the pair form of 8
  ((200, 170, 1), np.uint8, 11, 3.7),
  ((3, 5, 2), np.uint8, 8, 40.0),  # smaller than the grid: the reflection loops
  ((1, 9, 1), np.uint8, (2, 3), 2.0),
  ((64, 64, 2), np.uint16, 8, 40.0),
  ((70, 66, 2), np.uint16, (4, 8), 2.0),
  ((45, 64, 2), np.uint16, 8, 0.0),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_clahe_plain_equals_opencv(case):
  shape, dtype, grid, clip = CASES[case]
  img = _planes(shape, dtype, case)
  cv_grid = tuple(grid) if isinstance(grid, tuple) else (grid, grid)
  op = cv2.createCLAHE(clipLimit=clip, tileGridSize=cv_grid)
  want = np.stack([op.apply(img[:, :, z]) for z in range(shape[2])], axis=2)
  got = clahe_plain(torch.from_numpy(img), clip, grid)
  assert got.dtype == torch.from_numpy(img).dtype
  np.testing.assert_array_equal(got.numpy(), want)
  # the entry point takes the plain version on a CPU tensor
  np.testing.assert_array_equal(clahe(torch.from_numpy(img), clip, grid).numpy(), want)


def test_clahe_geometry_is_opencvs():
  # one axis divides: that axis still gains a whole extra grid of rows
  g = cuda_clahe.geometry(64, 70, 8, 40.0, 256)
  assert (g.pad_rows, g.pad_cols, g.th, g.tw) == (8, 2, 9, 9)
  g = cuda_clahe.geometry(64, 64, 8, 40.0, 256)
  assert (g.pad_rows, g.pad_cols, g.th, g.tw) == (0, 0, 8, 8)
  assert g.limit == max(int(40.0 * 64 / 256), 1) == 10
  assert cuda_clahe.geometry(64, 64, 8, 0.0, 256).limit == 0
  assert cuda_clahe.geometry(64, 64, 8, 0.5, 256).limit == 1
  # (gx, gy): gx tiles across the columns, gy across the rows
  g = cuda_clahe.geometry(96, 64, (4, 8), 1.0, 65536)
  assert (g.gx, g.gy, g.th, g.tw) == (4, 8, 12, 16)
  assert g.lut_scale == np.float32(65535) / np.float32(12 * 16)
  np.testing.assert_array_equal(cuda_clahe.reflect101(np.arange(-3, 9), 4),
                                [3, 2, 1, 0, 1, 2, 3, 2, 1, 0, 1, 2])


@pytest.mark.parametrize("bins, itemsize, grid, planes, batch, lut_blocks", [
  # a uint8 task cutout: every plane in one batch, a block a (plane, tile)
  (256, 1, 8, 64, 64, 64 * 64),
  # a uint16 task cutout: LUTs of 8 MiB a plane, 32 planes a batch, a
  # cluster of two blocks a (plane, tile)
  (65536, 2, 8, 64, 32, 2 * 32 * 64),
  # grid 64: one plane's LUTs (512 MiB) a batch, as OpenCV holds them
  (65536, 2, 64, 64, 1, 2 * 64 * 64),
])
def test_clahe_launch_plan_bounds_its_memory(bins, itemsize, grid, planes, batch, lut_blocks):
  g = cuda_clahe.geometry(2304, 2304, grid, 40.0, bins)
  plan = cuda_clahe.launch_plan(planes, g, itemsize)
  assert plan == (batch, lut_blocks)
  one_plane = g.gy * g.gx * bins * itemsize
  # a deeper stack takes no more than the budget
  for depth in (planes, 1000 * planes):
    deep_batch, deep_blocks = cuda_clahe.launch_plan(depth, g, itemsize)
    assert deep_batch * one_plane <= max(cuda_clahe.LUT_BYTES, one_plane)
    assert deep_blocks == deep_batch * g.gy * g.gx * (2 if bins > 4096 else 1)


@pytest.mark.parametrize("bins, itemsize", [(256, 1), (65536, 2)])
@pytest.mark.parametrize("rows, cols, grid", [(2304, 2304, 8), (1030, 1030, 8), (2304, 2050, 8),
                                              (768, 2304, (8, 4)), (7, 300, 13), (1, 1, 1)])
def test_clahe_launch_memory_is_bounded_and_has_no_scratch(bins, itemsize, rows, cols, grid):
  g = cuda_clahe.geometry(rows, cols, grid, 40.0, bins)
  one_plane = g.gy * g.gx * bins * itemsize
  tables = 16 * (rows + cols)
  sizes = [cuda_clahe.buffers(depth, g, itemsize) for depth in (1, 16, 64, 10**6)]
  for depth, got in zip((1, 16, 64, 10**6), sizes):
    # the LUTs of a batch and the weight tables, nothing else: no histogram
    # scratch, however deep the stack
    assert sorted(got) == ["column_table", "lut", "row_table"]
    assert got["row_table"] + got["column_table"] == tables
    assert got["lut"] <= max(cuda_clahe.LUT_BYTES, one_plane)
    assert got["lut"] == min(depth, cuda_clahe.launch_plan(depth, g, itemsize)[0]) * one_plane
  assert sizes[-1] == cuda_clahe.buffers(10**9, g, itemsize)


def test_clahe_weight_tables_are_the_plain_versions_weights():
  """The blend's row and column tables hold, bit for bit, the tiles and
  float32 weights that clahe_plain computes per voxel."""
  from igneous_tpu_torch.ops.clahe import _f32, _weights

  rng = np.random.default_rng(16)
  cases = [(1, 1, 1), (300, 300, 13), (2304, 2304, 8), (1030, 1030, 8), (2304, 2050, 8),
           (768, 2304, (8, 4))]
  for _ in range(40):
    rows, cols = (int(v) for v in rng.integers(1, 301, 2))
    square = rng.random() < 0.5
    grid = int(rng.integers(1, 14)) if square else tuple(int(v) for v in rng.integers(1, 14, 2))
    cases.append((rows, cols, grid))
  for rows, cols, grid in cases:
    g = cuda_clahe.geometry(rows, cols, grid, 40.0, 256)
    for n, inv, tiles in ((rows, g.inv_th, g.gy), (cols, g.inv_tw, g.gx)):
      table = cuda_clahe.weight_table(n, inv, tiles)
      assert table.shape == (n, 4) and table.dtype == np.int32
      t1, t2, a, a1 = (t.numpy() for t in _weights(n, _f32(inv), tiles))
      np.testing.assert_array_equal(table[:, 0], t1)
      np.testing.assert_array_equal(table[:, 1], t2)
      np.testing.assert_array_equal(table[:, 2], a.view(np.int32))
      np.testing.assert_array_equal(table[:, 3], a1.view(np.int32))
      assert (table[:, 0] >= 0).all() and (table[:, 1] < tiles).all()
      assert (np.diff(table[:, 0]) >= 0).all() and (np.diff(table[:, 1]) >= 0).all()


@pytest.mark.parametrize("window", [128, 256])  # kBlendRows, kBlendCols in csrc/clahe.cu
def test_clahe_blend_blocks_stay_within_their_staged_tiles(window):
  """A blend block stages the LUTs of min(g, (window - 1) // t + 4) tiles
  along each axis for its window of rows (or columns), and traps on the
  card past them: every window's t1 of its first index to t2 of its last
  fits, on random geometries."""
  rng = np.random.default_rng(window)
  cases = [(2304, 8), (768, 8), (1030, 8), (300, 13), (5000, 64), (1, 1)]
  cases += [(int(n), int(t)) for n, t in zip(rng.integers(1, 5000, 200), rng.integers(1, 70, 200))]
  for n, tiles in cases:
    g = cuda_clahe.geometry(n, 64, (1, tiles), 40.0, 256)
    table = cuda_clahe.weight_table(n, g.inv_th, g.gy)
    bound = min(g.gy, (window - 1) // g.th + 4)
    for r0 in range(0, n, window):
      last = min(r0 + window, n) - 1
      assert table[last, 1] - table[r0, 0] + 1 <= bound, (n, tiles, r0)


def test_clahe_variants_tool_still_edits_the_kernel():
  """tools/clahe_variants builds copies of csrc/clahe.cu with one design
  choice undone, by text: each edit must still find its text, once."""
  from igneous_tpu_torch.ops import _build
  from igneous_tpu_torch.tools import clahe_variants

  text = (_build.CSRC_DIR / "clahe.cu").read_text()
  for edits in clahe_variants.VARIANTS.values():
    assert clahe_variants.variant_source(text, edits) != text


def _split_lut16(hist, limit, scale):
  """A numpy model of csrc/clahe.cu's clahe_lut16 after its histogram: two
  halves of 32768 bins, each clipped on its own, the clipped counts and the
  first half's total exchanged, the residual's bins of each half bumped,
  and each half scanned from its own offset."""
  half = 32768
  halves = [hist[:half].astype(np.int64), hist[half:].astype(np.int64)]
  excess, total = [], []
  for h in halves:
    e = np.maximum(h - limit, 0) if limit > 0 else np.zeros_like(h)
    h -= e
    excess.append(int(e.sum()))
    total.append(int(h.sum()))
  clipped = sum(excess)
  batch, residual = clipped >> 16, clipped & 65535
  step = max(65536 // residual, 1) if residual else 1
  out = []
  for rank, h in enumerate(halves):
    lo = rank * half
    k0 = (lo + step - 1) // step
    k1 = min(residual, (lo + half + step - 1) // step) if residual else 0
    for k in range(k0, k1):
      h[k * step - lo] += 1
    offset = 0
    if rank == 1:
      bumps = min(residual, (half + step - 1) // step) if residual else 0
      offset = total[0] + batch * half + bumps
    cum = (offset + np.cumsum(h + batch)).astype(np.float32)
    out.append(np.clip(np.rint(cum * scale), 0, 65535).astype(np.int64))
  return np.concatenate(out)


@pytest.mark.parametrize("clip", [0.0, 0.01, 1.0, 40.0, 400.0])
@pytest.mark.parametrize("kind", ["noise", "constant", "low", "high", "two_values"])
def test_clahe_split_histogram_scan_is_the_plain_lut(kind, clip):
  """The 16-bit LUT pass's split of the bins over a cluster of two blocks
  gives clahe_plain's LUT, with the clipped residual falling in either half
  or both."""
  from igneous_tpu_torch.ops.clahe import _plane_lut

  rng = np.random.default_rng(7)
  shape = (96, 80)
  plane = {
    "noise": rng.integers(0, 65536, shape),
    "constant": np.full(shape, 40000),
    "low": rng.integers(0, 300, shape),
    "high": rng.integers(65000, 65536, shape),
    "two_values": np.where(rng.random(shape) < 0.5, 7, 50000),
  }[kind].astype(np.int64)
  g = cuda_clahe.geometry(*shape, 1, clip, 65536)
  want = _plane_lut(torch.from_numpy(plane), g).reshape(-1).numpy()
  hist = np.bincount(plane.reshape(-1), minlength=65536)
  got = _split_lut16(hist, g.limit, g.lut_scale)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8, torch.uint32])
def test_clahe_refuses_other_types(dtype):
  x = torch.zeros((16, 16, 1), dtype=dtype)
  with pytest.raises(TypeError):
    clahe(x)
  with pytest.raises(TypeError):
    clahe_plain(x)


def test_clahe_kernel_needs_a_cuda_tensor():
  with pytest.raises(ValueError):
    cuda_clahe.launch(torch.zeros((1, 8, 8), dtype=torch.uint8), 40.0, 8)


# ---------------------------------------------------------------------------
# the tasks through both factories


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_luminance_levels_match_reference(tmp_path, dtype):
  data = image(SHAPE, dtype=np.uint16 if dtype == np.int16 else dtype)
  if dtype == np.int16:
    data = (data // 2).astype(np.int16)  # non-negative signed values
  roots = layers(tmp_path, data)
  tasks = both(roots, lambda lib, path, side: lib.create_luminance_levels_tasks(
    path, coverage_factor=0.5))
  assert all(type(t) is LuminanceLevelsTask for t in tasks["port"])
  assert len(tasks["port"]) == 2  # one task a chunk-z slab
  assert tree(roots["port"], "src") == tree(roots["jax"], "src")
  levels = json.loads((roots["port"] / "src" / "levels" / "0" / "3").read_text())
  assert sum(levels["levels"]) == levels["num_samples"]


def test_luminance_levels_of_uint64_above_2_63_match_reference(tmp_path):
  data = image(SHAPE).astype(np.uint64) * np.uint64(2**56) + np.uint64(12345)
  roots = layers(tmp_path, data, layer_type="image")
  both(roots, lambda lib, path, side: lib.create_luminance_levels_tasks(
    path, coverage_factor=0.2, shape=(301, 211, 4), offset=(0, 0, 8)))
  assert tree(roots["port"], "src") == tree(roots["jax"], "src")
  levels = json.loads((roots["port"] / "src" / "levels" / "0" / "9").read_text())
  assert levels["bin_width"] == 2**56 and sum(levels["levels"][128:]) > 0


def test_luminance_levels_of_negative_values_raise_in_both(tmp_path):
  data = (image(SHAPE).astype(np.int16) - 100).astype(np.int16)
  roots = layers(tmp_path, data)
  for side, lib, queue in (("jax", jax_tc, _jax_queue()), ("port", tc, LocalTaskQueue())):
    with pytest.raises(Exception) as err:
      queue.insert(lib.create_luminance_levels_tasks(f"file://{roots[side] / 'src'}"))
    assert isinstance(err.value, ValueError)


@pytest.mark.parametrize("kw", [
  dict(),
  dict(translate=(32, 0, 16), minval=10, maxval=200, clip_fraction=0.05,
       shape=(96, 128, 16)),
  dict(box=((40, 10, 4), (260, 190, 18)), bounds_mip=0, shape=(64, 64, 16)),
], ids=["defaults", "translate_minmax", "bounds"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_contrast_normalization_matches_reference(tmp_path, kw, dtype):
  roots = layers(tmp_path, image(SHAPE, dtype=dtype))
  both(roots, lambda lib, path, side: lib.create_luminance_levels_tasks(
    path, coverage_factor=0.3))
  kw = dict(kw)
  bx = kw.pop("box", None)
  if dtype == np.uint16:
    kw.setdefault("maxval", 60000)
  tasks = both(roots, lambda lib, path, side: lib.create_contrast_normalization_tasks(
    path, path.replace("/src", "/dest"),
    bounds=None if bx is None else box(side, *bx), **kw))
  assert all(type(t) is ContrastNormalizationTask for t in tasks["port"])
  assert tree(roots["port"], "dest") == tree(roots["jax"], "dest")
  assert tree(roots["port"], "src") == tree(roots["jax"], "src")


def test_contrast_normalization_of_two_channels_and_uint64(tmp_path):
  data = np.stack([image(SHAPE), image(SHAPE, seed=1)], axis=3)
  data64 = image(SHAPE).astype(np.uint64) * np.uint64(2**56) + np.uint64(2**40 + 3)
  for name, arr in (("two", data), ("u64", data64)):
    roots = layers(tmp_path / name, arr, layer_type="image")
    both(roots, lambda lib, path, side: lib.create_luminance_levels_tasks(
      path, coverage_factor=0.3))
    both(roots, lambda lib, path, side: lib.create_contrast_normalization_tasks(
      path, path.replace("/src", "/dest"), maxval=250))
    assert tree(roots["port"], "dest") == tree(roots["jax"], "dest")


def test_contrast_normalization_without_levels_raises(tmp_path):
  roots = layers(tmp_path, image(SHAPE))
  tasks = list(tc.create_contrast_normalization_tasks(
    f"file://{roots['port'] / 'src'}", f"file://{roots['port'] / 'dest'}"))
  with pytest.raises(FileNotFoundError):
    tasks[0].execute()


@pytest.mark.parametrize("dtype,grid,clip,shape", [
  (np.uint8, 8, 40.0, (128, 128, 16)),  # edge tasks, pads that do not divide
  (np.uint8, (4, 8), 2.0, (128, 96, 16)),
  (np.uint8, [8, 8], 0.0, (160, 211, 20)),  # x divides by the grid, y does not
  (np.uint16, 8, 40.0, (160, 128, 16)),
  (np.uint16, (4, 8), 2.0, (301, 211, 20)),  # one task, no pad
], ids=["u8_grid8_clip40", "u8_pair_clip2", "u8_clip0_one_axis", "u16_grid8", "u16_pair"])
def test_clahe_tasks_match_reference(tmp_path, dtype, grid, clip, shape):
  roots = layers(tmp_path, image(SHAPE, dtype=dtype))
  tasks = both(roots, lambda lib, path, side: lib.create_clahe_tasks(
    path, path.replace("/src", "/dest"), clip_limit=clip, tile_grid_size=grid,
    shape=shape))
  assert all(type(t) is CLAHETask for t in tasks["port"])
  assert tree(roots["port"], "dest") == tree(roots["jax"], "dest")
  chunks = sorted(p.name for p in (roots["port"] / "dest" / "8_8_40").iterdir())
  assert chunks == sorted(p.name for p in (roots["port"] / "src" / "8_8_40").iterdir())
  src = JaxVolume(f"file://{roots['jax'] / 'src'}")
  dst = JaxVolume(f"file://{roots['port'] / 'dest'}")
  assert not np.array_equal(dst.download(dst.bounds), src.download(src.bounds))


def test_clahe_task_payload_from_reference_runs(tmp_path):
  roots = layers(tmp_path, image(SHAPE))
  for side in roots:
    path = f"file://{roots[side] / 'src'}"
    jax_tasks = list(jax_tc.create_clahe_tasks(
      path, path.replace("/src", "/dest"), tile_grid_size=(4, 8), shape=(128, 128, 20)))
    for t in jax_tasks:
      if side == "jax":
        t.execute()
      else:
        deserialize(jax_serialize(t)).execute()
  flush_local()
  assert layer_tree(roots["port"] / "dest") == layer_tree(roots["jax"] / "dest")


def test_clahe_of_float_raises_in_both(tmp_path):
  roots = layers(tmp_path, image(SHAPE).astype(np.float32))
  for side, lib in (("jax", jax_tc), ("port", tc)):
    path = f"file://{roots[side] / 'src'}"
    task = next(iter(lib.create_clahe_tasks(path, path.replace("/src", "/dest"))))
    with pytest.raises(Exception) as err:
      task.execute()
    if side == "jax":
      assert type(task) is JaxCLAHETask and type(err.value).__module__.startswith("cv2")
    else:
      assert isinstance(err.value, TypeError)


# ---------------------------------------------------------------------------
# the command lines


@pytest.mark.parametrize("grid", ["8", "4,8"])
def test_cli_contrast_commands_match_reference(tmp_path, grid):
  roots = layers(tmp_path, image(SHAPE))
  runs = [
    ["image", "contrast", "histogram", "file://ROOT/src", "--coverage", "0.4"],
    ["image", "contrast", "equalize", "file://ROOT/src", "file://ROOT/eq",
     "--clip-fraction", "0.02", "--maxval", "220", "--xrange", "0,256",
     "--shape", "128,128,16"],
    ["image", "contrast", "clahe", "file://ROOT/src", "file://ROOT/cl",
     "--tile-grid-size", grid, "--clip-limit", "3", "--shape", "128,128,16",
     "--zrange", "0,16"],
  ]
  for args in runs:
    res = CliRunner().invoke(jax_cli, [a.replace("ROOT", str(roots["jax"])) for a in args])
    assert res.exit_code == 0, res.output
    assert cli_main([a.replace("ROOT", str(roots["port"])) for a in args]) == 0
  for name in ("src", "eq", "cl"):
    assert tree(roots["port"], name) == tree(roots["jax"], name)


def test_cli_clahe_through_a_queue(tmp_path):
  roots = layers(tmp_path, image(SHAPE))
  spec = f"fq://{tmp_path / 'q'}"
  assert cli_main(["image", "contrast", "clahe", f"file://{roots['port'] / 'src'}",
                   f"file://{roots['port'] / 'cl'}", "--tile-grid", "4",
                   "--shape", "160,160,20", "--queue", spec]) == 0
  assert cli_main(["execute", spec, "-x", "-q"]) == 0
  res = CliRunner().invoke(jax_cli, [
    "image", "contrast", "clahe", f"file://{roots['jax'] / 'src'}",
    f"file://{roots['jax'] / 'cl'}", "--tile-grid", "4", "--shape", "160,160,20"])
  assert res.exit_code == 0, res.output
  assert tree(roots["port"], "cl") == tree(roots["jax"], "cl")
