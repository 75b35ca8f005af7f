"""The port's multilabel morphology against the JAX package's.

``dilate`` (the JAX package's XLA ``_dilate_kernel`` per step; the port's
torch ``dilate_step``), ``erode`` and ``fill_holes`` at levels 1-3 must
equal the JAX package's bit for bit, on seeded random multilabel volumes
of 1-19 voxels a side (uint8, uint32, uint64 ids at or above 2^63, int16
with negative ids, bool), with and without background, with ties on
several axes and with extents of 1; and on float32 and float64 labels
(both zeros, ties), compared on the bits.
"""

import numpy as np
import pytest
import torch

from igneous_tpu.ops import morphology as jax_morph
from igneous_tpu_torch import device
from igneous_tpu_torch.ops import morphology as morph

DTYPES = {
  "uint8": (np.uint8, [0, 3, 6, 9, 200]),
  "uint32": (np.uint32, [0, 7, 2**31 + 5, 2**32 - 1, 12]),
  "uint64": (np.uint64, [0, 2**63, 2**63 + 5, 2**64 - 2, 2**40]),
  "int16": (np.int16, [0, -3, 5, 300, -7]),
  "bool": (np.bool_, [False, True]),
}


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


def random_labels(seed: int, dtype_name: str, background: bool = True) -> np.ndarray:
  """(x, y, z) labels 1-19 voxels a side drawn from the dtype's ids; no
  zero at all when ``background`` is False."""
  rng = np.random.default_rng(seed)
  dtype, ids = DTYPES[dtype_name]
  ids = np.asarray(ids, dtype=dtype)
  shape = tuple(int(v) for v in rng.integers(1, 20, 3))
  n = int(rng.integers(2, len(ids) + 1))
  pool = ids[:n] if background else ids[1:n] if n > 2 else ids[1:]
  p = rng.random(len(pool))
  if background:
    p[0] *= 3  # mostly background, as in a segmentation
  return rng.choice(pool, size=shape, p=p / p.sum()).astype(dtype)


CASES = [(seed, name) for seed in range(4) for name in sorted(DTYPES)]


@pytest.mark.parametrize("seed,dtype_name", CASES)
def test_dilate_matches_reference(seed, dtype_name):
  labels = random_labels(seed, dtype_name)
  iterations = 1 + seed % 3
  got = morph.dilate(labels, iterations)
  ref = jax_morph.dilate(labels, iterations)
  assert got.dtype == ref.dtype and got.shape == ref.shape
  assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype_name", ["uint8", "uint64", "int16"])
def test_dilate_without_background_matches_reference(dtype_name):
  # no zero: the renumbering prepends one, and nothing grows
  labels = random_labels(5, dtype_name, background=False)
  assert labels.all() or dtype_name == "int16"
  assert np.array_equal(morph.dilate(labels, 2), jax_morph.dilate(labels, 2))


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 7, 1), (5, 1, 1), (1, 1, 9), (3, 1, 4)])
def test_dilate_and_erode_on_extents_of_one(shape):
  rng = np.random.default_rng(sum(shape))
  labels = rng.choice(np.asarray([0, 2**63 + 1, 4], np.uint64), size=shape)
  assert np.array_equal(morph.dilate(labels), jax_morph.dilate(labels))
  assert np.array_equal(morph.erode(labels), jax_morph.erode(labels))


def test_dilate_ties_follow_the_axis_order():
  """A background voxel whose neighbours hold different labels the same
  number of times takes the first in -z, +z, -y, +y, -x, +x (of the
  (z, y, x) layout): here the +x neighbour (a voxel's -z in the x-last
  array) against the others."""
  cases = []
  base = np.zeros((5, 5, 5), np.uint64)
  c = (2, 2, 2)
  # one each on six sides: the first in the order wins
  one_each = base.copy()
  for i, (axis, d) in enumerate([(2, -1), (2, 1), (1, -1), (1, 1), (0, -1), (0, 1)]):
    p = list(c)
    p[axis] += d
    one_each[tuple(p)] = 2**63 + 10 * (i + 1)
  cases.append(one_each)
  # two each of two labels on different axes
  two_each = base.copy()
  two_each[2, 2, 1] = two_each[2, 2, 3] = 2**63 + 1  # along z
  two_each[1, 2, 2] = two_each[3, 2, 2] = 7          # along x
  cases.append(two_each)
  # two against two against one
  mixed = two_each.copy()
  mixed[2, 1, 2] = 9
  mixed[2, 3, 2] = 7
  cases.append(mixed)
  for labels in cases:
    got = morph.dilate(labels)
    assert np.array_equal(got, jax_morph.dilate(labels))
  # the z neighbour (first in the order) wins the two-against-two tie
  assert morph.dilate(cases[1])[c] == 2**63 + 1
  assert morph.dilate(cases[2])[c] == 7


def test_dilate_step_matches_the_reference_program():
  """The single step on dense int32 labels, in the (z, y, x) layout,
  against the JAX package's ``_dilate_kernel`` itself."""
  rng = np.random.default_rng(3)
  dense = rng.choice(4, size=(9, 11, 13), p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
  got = morph.dilate_step(torch.from_numpy(dense)).numpy()
  ref = np.asarray(jax_morph._dilate_kernel(dense))
  assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed,dtype_name", CASES)
def test_erode_matches_reference(seed, dtype_name):
  labels = random_labels(seed + 10, dtype_name)
  # solid blocks give erosion something to keep
  labels[: labels.shape[0] // 2] = labels.flat[0]
  iterations = 1 + seed % 2
  got = morph.erode(labels, iterations)
  ref = jax_morph.erode(labels, iterations)
  assert got.dtype == ref.dtype
  assert np.array_equal(got, ref)


FLOAT_IDS = [0.0, -0.0, 1.5, 1.5000001, 2.25, -3.0, 1e30]


def float_labels(seed: int, dtype) -> np.ndarray:
  """(x, y, z) float labels 1-13 voxels a side: both zeros, values that
  differ in the last bits of float32 and of neither, and a negative."""
  rng = np.random.default_rng(seed)
  shape = tuple(int(v) for v in rng.integers(1, 14, 3))
  p = np.asarray([4, 3, 1, 1, 1, 1, 1], np.float64)
  return rng.choice(np.asarray(FLOAT_IDS, dtype), size=shape, p=p / p.sum()).astype(dtype)


def bits(a: np.ndarray) -> np.ndarray:
  """The integer view of a float array: -0.0 and 0.0 differ there."""
  return a.view(f"u{a.itemsize}")


FLOAT_CASES = [(seed, dt) for seed in range(3) for dt in ("float32", "float64")]


@pytest.mark.parametrize("seed,dtype_name", FLOAT_CASES)
def test_dilate_and_erode_on_float_labels_match_reference(seed, dtype_name):
  """Float labels as the JAX package takes them, bit for bit: -0.0 is
  background beside 0.0, NaN-free values that float32 tells apart stay
  apart, and the representative zero is the one ``np.unique`` keeps."""
  labels = float_labels(seed, np.dtype(dtype_name))
  for iterations in (1, 2):
    for fn, ref_fn in ((morph.dilate, jax_morph.dilate), (morph.erode, jax_morph.erode)):
      got, ref = fn(labels, iterations), ref_fn(labels, iterations)
      assert got.dtype == ref.dtype and got.shape == ref.shape
      assert np.array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("seed,dtype_name", FLOAT_CASES)
def test_fill_holes_on_float_labels_matches_reference(seed, dtype_name):
  labels = float_labels(seed + 7, np.dtype(dtype_name))
  for level in (1, 3):
    got = morph.fill_holes(labels, return_fill_count=True, level=level)
    ref = jax_morph.fill_holes(labels, return_fill_count=True, level=level)
    assert got[0].dtype == ref[0].dtype
    assert np.array_equal(bits(got[0]), bits(ref[0])) and got[1] == ref[1]


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_float_dilate_ties_and_negative_zero_match_reference(dtype_name):
  """Ties between float labels follow the axis order, and a -0.0 voxel
  is background that the dilation fills (with no negative label, zero is
  the first of ``np.unique``'s ids)."""
  dtype = np.dtype(dtype_name)
  lab = np.zeros((5, 5, 5), dtype)
  c = (2, 2, 2)
  lab[c] = -0.0
  lab[2, 2, 1] = lab[2, 2, 3] = 1.5
  lab[1, 2, 2] = lab[3, 2, 2] = 2.25
  lab[0, 0, 0] = -0.0
  got, ref = morph.dilate(lab), jax_morph.dilate(lab)
  assert got.dtype == ref.dtype and np.array_equal(bits(got), bits(ref))
  assert got[c] == 1.5
  got, ref = morph.erode(lab), jax_morph.erode(lab)
  assert np.array_equal(bits(got), bits(ref))


def shell(dtype=np.uint64, crack: bool = False) -> np.ndarray:
  """A cube of label 3 (or 2^63 + 3) around a 4^3 cavity; ``crack`` opens
  it to the outside with a 2x2 channel along z."""
  label = 2**63 + 3 if dtype == np.uint64 else 3
  lab = np.zeros((16, 16, 16), dtype)
  lab[2:14, 2:14, 2:14] = label
  lab[6:10, 6:10, 6:10] = 0
  if crack:
    lab[7:9, 7:9, 2:10] = 0
  lab[3, 3, 3] = 0  # a one-voxel cavity too
  lab[12:14, 2:4, 2:4] = 5  # another label in the corner
  return lab


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("crack", [False, True])
def test_fill_holes_matches_reference(level, crack):
  lab = shell(crack=crack)
  got, got_counts = morph.fill_holes(lab, return_fill_count=True, level=level)
  ref, ref_counts = jax_morph.fill_holes(lab, return_fill_count=True, level=level)
  assert got.dtype == ref.dtype
  assert np.array_equal(got, ref)
  assert got_counts == ref_counts
  assert np.array_equal(morph.fill_holes(lab, level=level), ref)


def test_fill_holes_level_3_closes_the_cracked_cavity():
  """As the JAX package's test_fill_holes_level3_closes_cracked_cavity:
  level 1 leaves the cracked cavity open, level 3 closes it."""
  lab = shell(np.uint64, crack=True)
  label = np.uint64(2**63 + 3)
  assert (morph.fill_holes(lab, level=1)[6:10, 6:10, 6:10] == 0).any()
  closed, counts = morph.fill_holes(lab, return_fill_count=True, level=3)
  assert (closed[6:10, 6:10, 6:10] == label).all()
  assert counts[int(label)] > 64


@pytest.mark.parametrize("seed,dtype_name", [(s, n) for s in range(3) for n in ("uint32", "uint64")])
def test_fill_holes_on_random_labels_matches_reference(seed, dtype_name):
  labels = random_labels(seed + 20, dtype_name)
  for level in (1, 3):
    got = morph.fill_holes(labels, return_fill_count=True, level=level)
    ref = jax_morph.fill_holes(labels, return_fill_count=True, level=level)
    assert np.array_equal(got[0], ref[0]) and got[1] == ref[1]
