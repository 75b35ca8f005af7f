"""The port's paged batching (``igneous_tpu_torch.parallel.paged``) and its
batched CCL and EDT against the JAX package, bit for bit.

A ragged fleet of cutouts goes through fixed pages with an extent beside
each: the paged pyramid must equal the JAX package's ``paged_pyramid``
and the port's own solo ``downsample``; ``paged_ccl`` and
``connected_components_batch`` the JAX package's ``connected_components``
at 6, 18 and 26-connectivity; ``paged_edt`` and ``edt_batch`` the JAX
package's ``edt(..., black_border=True)`` on its native host path (the
port's EDT contract), and its float32 device ``paged_edt`` within a stated
tolerance. Also: the page knobs and their errors, ``split_unstarted``,
and launches per page round that do not depend on the items' shapes.
"""

import numpy as np
import pytest

from igneous_tpu.ops import edt as jax_edt
from igneous_tpu.ops.ccl import connected_components as jax_cc
from igneous_tpu.parallel import paged as jax_paged
from igneous_tpu_torch import device
from igneous_tpu_torch.ops import ccl, cuda_pooling, edt, pooling
from igneous_tpu_torch.parallel import paged


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  # the reference runs its device (XLA) pyramid and its native host EDT
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  monkeypatch.delenv("IGNEOUS_PAGE_SHAPE", raising=False)
  monkeypatch.delenv("IGNEOUS_PAGE_BATCH", raising=False)
  device.reset_device()
  yield
  device.reset_device()


# the JAX package's ragged shapes: nothing page-aligned, edges on every
# axis, and a single voxel
RAGGED_SHAPES = [(64, 64, 32), (33, 64, 17), (7, 5, 3), (64, 33, 64), (1, 1, 1)]


def _fleet(rng, dtype, shapes=RAGGED_SHAPES, channels=None):
  imgs = []
  for s in shapes:
    img = rng.integers(0, 200, s + ((channels,) if channels else ())).astype(dtype)
    if np.dtype(dtype).itemsize == 8:  # labels above 2^32
      img[img == 3] = np.uint64(2**40 + 7)
    imgs.append(img)
  return imgs


# ---------------------------------------------------------------------------
# paged pyramid


@pytest.mark.parametrize("dtype,method,factor,num_mips,sparse", [
  (np.uint8, "average", (2, 2, 1), 2, False),
  (np.uint64, "mode", (2, 2, 2), 1, True),
  (np.uint32, "mode", (2, 2, 1), 2, False),
  (np.uint16, "average", (2, 2, 1), 3, False),
  (np.uint8, "average", ((2, 2, 1), (2, 2, 2)), 2, False),
])
def test_paged_pyramid_equals_jax_and_solo(dtype, method, factor, num_mips, sparse):
  rng = np.random.default_rng(42)
  imgs = _fleet(rng, dtype)
  got = paged.paged_pyramid(imgs, factor, num_mips, method=method, sparse=sparse)
  want = jax_paged.paged_pyramid(imgs, factor, num_mips, method=method, sparse=sparse)
  assert len(got) == len(want) == len(imgs)
  for img, g_mips, w_mips in zip(imgs, got, want):
    solo = pooling.downsample(img, factor, num_mips, method=method, sparse=sparse)
    assert len(g_mips) == len(w_mips) == len(solo) == num_mips
    for g, w, s in zip(g_mips, w_mips, solo):
      assert g.dtype == w.dtype == s.dtype
      assert g.shape == w.shape == s.shape, img.shape
      assert np.array_equal(g, w), img.shape
      assert np.array_equal(g, s), img.shape


def test_paged_pyramid_channels():
  rng = np.random.default_rng(7)
  imgs = _fleet(rng, np.uint8, [(33, 18, 9), (64, 64, 32), (5, 5, 5)], channels=3)
  got = paged.paged_pyramid(imgs, (2, 2, 1), 2, method="average")
  want = jax_paged.paged_pyramid(imgs, (2, 2, 1), 2, method="average")
  for g_mips, w_mips in zip(got, want):
    for g, w in zip(g_mips, w_mips):
      assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("batch", ["1", "3", "64"])
def test_paged_pyramid_rounds_split_items(monkeypatch, batch):
  """Small rounds cut items across rounds; the output is the same."""
  monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", "8,8,8")
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", batch)
  rng = np.random.default_rng(3)
  imgs = _fleet(rng, np.uint8, [(20, 17, 9), (16, 16, 16), (3, 30, 11)])
  p = paged.PagedPyramid(imgs, (2, 2, 1), 2, method="average")
  assert p.cap == {"1": 1, "3": 4, "64": 64}[batch]
  got = p.run()
  for img, mips in zip(imgs, got):
    for g, s in zip(mips, pooling.downsample(img, (2, 2, 1), 2, method="average")):
      assert np.array_equal(g, s)


def test_page_round_launches_do_not_depend_on_shapes(monkeypatch):
  """The JAX package asserts one compiled signature a campaign; the port's
  counterpart: every round of any fleet makes the same calls (one 2x2x1
  pooling call per level of the kernels' run, three clamp-gathers per
  level) on the same page batch shape."""
  monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", "16,16,16")
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "8")
  calls = []
  real_pool, real_gather = cuda_pooling.pool2x2x1, paged.torch.gather

  def pool_spy(x, method="average"):
    calls.append(("pool2x2x1", tuple(x.shape[2:])))
    return real_pool(x, method)

  def gather_spy(x, dim, index):
    calls.append(("gather", dim))
    return real_gather(x, dim, index)

  monkeypatch.setattr(cuda_pooling, "pool2x2x1", pool_spy)
  monkeypatch.setattr(paged.torch, "gather", gather_spy)
  rng = np.random.default_rng(5)
  per_round = set()
  for shapes in (RAGGED_SHAPES, [(40, 3, 33), (16, 16, 16)], [(1, 1, 1)]):
    p = paged.PagedPyramid(_fleet(rng, np.uint8, shapes), (2, 2, 1), 2)
    while p.pending:
      calls.clear()
      p.run_round()
      per_round.add(tuple(calls))
  assert per_round == {(
    ("gather", 2), ("gather", 3), ("gather", 4), ("pool2x2x1", (16, 16, 16)),
    ("gather", 2), ("gather", 3), ("gather", 4), ("pool2x2x1", (16, 8, 8)),
  )}


def test_page_knobs_and_errors(monkeypatch):
  assert paged.page_shape() == (32, 32, 32)
  assert paged.pages_compatible(((2, 2, 1), (2, 2, 2)))
  assert not paged.pages_compatible(((3, 3, 3),))
  assert not paged.pages_compatible(((2, 2, 1),) * 6)  # cumulative 64 > 32
  assert paged.ccl_page_compatible()
  for fn in (paged.pages_compatible, jax_paged.pages_compatible):
    assert fn(((1, 1, 2),) * 5) and not fn(((1, 1, 2),) * 6)
  monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", "64,32,32")
  assert paged.page_shape() == jax_paged.page_shape() == (64, 32, 32)
  assert paged.pages_compatible(((1, 1, 2),) * 6)  # z cumulative 64
  for bad in ("0,32,32", "32,32", "-1,2,3"):
    monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", bad)
    with pytest.raises(ValueError) as got:
      paged.page_shape()
    with pytest.raises(ValueError) as want:
      jax_paged.page_shape()
    assert str(got.value) == str(want.value)
    assert "IGNEOUS_PAGE_SHAPE must be three positive ints 'pz,py,px'" in str(got.value)
  monkeypatch.delenv("IGNEOUS_PAGE_SHAPE")
  assert paged.page_round_cap() == 32
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "5")
  assert paged.page_round_cap() == jax_paged.page_round_cap(1) == 8
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "-2")
  with pytest.raises(ValueError, match="IGNEOUS_PAGE_BATCH must be positive"):
    paged.page_round_cap()
  monkeypatch.setenv("IGNEOUS_CCL_TILE", "3,4,5")
  assert not paged.ccl_page_compatible()


def test_incompatible_fleets_refused():
  rng = np.random.default_rng(1)
  with pytest.raises(ValueError, match="pages_compatible"):
    paged.PagedPyramid([rng.integers(0, 9, (9, 9, 9)).astype(np.uint8)], (3, 3, 3), 1)
  with pytest.raises(ValueError, match="share dtype and channel count"):
    paged.PagedPyramid([np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 4), np.uint16)],
                       (2, 2, 1), 1)
  with pytest.raises(ValueError, match="need at least one image"):
    paged.PagedPyramid([], (2, 2, 1), 1)
  with pytest.raises(ValueError, match="floating-point"):
    paged.PagedPyramid([np.zeros((4, 4, 4), np.float64)], (2, 2, 1), 1, method="mode")


def test_split_unstarted_sheds_only_untouched_items(monkeypatch):
  monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", "4,4,4")
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "1")
  rng = np.random.default_rng(2)
  imgs = [
    rng.integers(0, 255, (4, 4, 4)).astype(np.uint8),  # 1 page
    rng.integers(0, 255, (8, 4, 4)).astype(np.uint8),  # 2 pages
    rng.integers(0, 255, (4, 8, 8)).astype(np.uint8),  # 4 pages
  ]
  from igneous_tpu.parallel.executor import make_mesh

  for mod, kw in ((paged, {}), (jax_paged, {"mesh": make_mesh(1)})):
    p = mod.PagedPyramid(imgs, (2, 2, 2), 1, method="average", **kw)
    assert p.rounds_remaining == 7
    assert p.run_round() == [0]
    p.run_round()  # item 1's first page
    assert p.split_unstarted() == [2]
    assert p.rounds_remaining == 1
    assert p.split_unstarted() == []
    while p.pending:
      p.run_round()
    with pytest.raises(ValueError, match="not complete"):
      p.result(2)
    for i in (0, 1):
      want = pooling.downsample(imgs[i], (2, 2, 2), 1, method="average")
      assert np.array_equal(p.result(i)[0], want[0])
    assert len(p.run()) == 2


# ---------------------------------------------------------------------------
# paged and batched CCL


def _multilabel(rng, shape, dtype=np.uint32):
  return ((rng.random(shape) < 0.55) * rng.integers(1, 4, shape)).astype(dtype)


@pytest.mark.parametrize("connectivity", [6, 18, 26])
def test_paged_ccl_equals_jax(connectivity):
  rng = np.random.default_rng(connectivity)
  labs = [_multilabel(rng, s) for s in [(40, 33, 21), (17, 3, 9), (64, 64, 32), (1, 1, 5)]]
  labs.append(labs[0].astype(np.uint64) * np.uint64(2**40))
  for lab, got in zip(labs, paged.paged_ccl(labs, connectivity)):
    want = jax_cc(lab, connectivity)
    assert got.dtype == want.dtype and np.array_equal(got, want), lab.shape


def test_paged_ccl_small_pages_and_rounds(monkeypatch):
  """Pages of 8 (the CPU tile (2, 4, 8) divides them) in rounds of 4:
  many page seams, items cut across rounds."""
  monkeypatch.setenv("IGNEOUS_PAGE_SHAPE", "8,8,8")
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "4")
  rng = np.random.default_rng(11)
  labs = [_multilabel(rng, s) for s in [(30, 21, 19), (8, 8, 8), (2, 17, 3)]]
  for lab, got in zip(labs, paged.paged_ccl(labs, 26)):
    assert np.array_equal(got, jax_cc(lab, 26))


def test_paged_ccl_refuses_what_it_cannot_page(monkeypatch):
  with pytest.raises(ValueError):
    paged.paged_ccl([np.zeros((4, 4, 4), np.uint8)], 5)
  with pytest.raises(ValueError, match=r"labels must be \(x, y, z\)"):
    paged.paged_ccl([np.zeros((4, 4), np.uint8)])
  monkeypatch.setenv("IGNEOUS_CCL_TILE", "3,4,5")
  with pytest.raises(ValueError, match="ccl_page_compatible"):
    paged.paged_ccl([np.zeros((4, 4, 4), np.uint8)])


@pytest.mark.parametrize("connectivity", [6, 18, 26])
def test_connected_components_batch_equals_jax(connectivity):
  rng = np.random.default_rng(100 + connectivity)
  batch = np.stack([_multilabel(rng, (23, 17, 11), np.uint64) for _ in range(3)])
  batch[1] *= np.uint64(2**33)
  got = ccl.connected_components_batch(batch, connectivity)
  assert len(got) == 3
  for lab, g in zip(batch, got):
    assert np.array_equal(g, jax_cc(lab, connectivity))
  with pytest.raises(ValueError, match=r"\(K, x, y, z\)"):
    ccl.connected_components_batch(batch[0], connectivity)


# ---------------------------------------------------------------------------
# paged and batched EDT


ANIS = (1.8, 1.0, 2.5)


def _edt_fleet(rng, shapes, dtype=np.uint32):
  labs = [((rng.random(s) < 0.6) * rng.integers(1, 3, s)).astype(dtype) for s in shapes]
  if np.dtype(dtype).itemsize == 8:
    labs[0][labs[0] == 2] = np.uint64(2**63 + 5)
  return labs


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.uint8])
def test_paged_edt_equals_native_edt(dtype):
  rng = np.random.default_rng(9)
  labs = _edt_fleet(rng, [(19, 13, 7), (40, 9, 21), (3, 3, 3)], dtype)
  got = paged.paged_edt(labs, ANIS)
  for lab, g in zip(labs, got):
    want = jax_edt.edt(lab, ANIS, black_border=True)
    assert g.dtype == np.float32 and g.shape == lab.shape
    assert np.array_equal(g, want), lab.shape
    assert np.array_equal(g, edt.edt(lab, ANIS, black_border=True))


def test_paged_edt_pads_both_ways_to_the_same_fields(monkeypatch):
  """The JAX package pads to a power-of-two page count, the port to a
  page multiple: with a black border both give the same fields."""
  rng = np.random.default_rng(4)
  labs = _edt_fleet(rng, [(33, 13, 7), (5, 40, 21)])
  ours = paged.paged_edt(labs, ANIS, page=(8, 8, 8))
  assert paged.canonical_shape([(7, 13, 33), (21, 40, 5)], (8, 8, 8)) == (24, 48, 40)

  def pow2(shapes, page):
    out = []
    for a in range(3):
      n = -(-(max(s[a] for s in shapes) + 2) // page[a])
      out.append((1 << (n - 1).bit_length()) * page[a])
    return tuple(out)

  monkeypatch.setattr(paged, "canonical_shape", pow2)
  theirs = paged.paged_edt(labs, ANIS, page=(8, 8, 8))
  for a, b in zip(ours, theirs):
    assert np.array_equal(a, b)


def test_paged_edt_against_jax_device_variant(monkeypatch):
  """The JAX package's own paged_edt runs its float32 XLA EDT; the port
  holds the native host contract, so the two agree only within float32
  rounding: relative 1e-6, absolute 1e-6 (the envelope's intersections
  and heights are computed in float32 there, in double here)."""
  rng = np.random.default_rng(6)
  labs = _edt_fleet(rng, [(19, 13, 7), (12, 9, 21)])
  ours = paged.paged_edt(labs, ANIS)
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "device")
  theirs = jax_paged.paged_edt(labs, ANIS)
  for a, b in zip(ours, theirs):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("black_border", [False, True])
def test_edt_batch_equals_native_edt(black_border):
  rng = np.random.default_rng(12)
  batch = np.stack(_edt_fleet(rng, [(17, 11, 9)] * 3, np.uint64))
  got = edt.edt_batch(batch, ANIS, black_border=black_border)
  assert len(got) == 3
  for lab, g in zip(batch, got):
    assert np.array_equal(g, jax_edt.edt(lab, ANIS, black_border=black_border))
    assert np.array_equal(g, edt.edt(lab, ANIS, black_border=black_border))
  with pytest.raises(ValueError, match=r"\(K, x, y, z\)"):
    edt.edt_batch(batch[0], ANIS)
