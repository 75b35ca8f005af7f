"""The port's block connected components against the JAX package, bit for bit.

(a) cuda_ccl.tile_resolve_plain against the Pallas tile_resolve in interpret
mode; (b) ops.ccl.connected_components against the JAX connected_components
on each of its backends (native two-pass, device lax engine, device Pallas
engine in interpret mode), over label types, degenerate shapes and tiles
smaller and larger than the volume; (c) dust; (d) the CUDA wrapper never
falls back to its plain version. CCL numbering is an exact contract, so
every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from igneous_tpu.ops import ccl as jax_ccl
from igneous_tpu.ops import pallas_ccl
from igneous_tpu_torch import device
from igneous_tpu_torch.ops import ccl, cuda_ccl


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.delenv("IGNEOUS_CCL_TILE", raising=False)
  device.reset_device()
  yield
  device.reset_device()


@pytest.fixture
def needs_cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU with CUDA (run by chip_smoke.py on the card)")


def _multilabel(rng, shape, dtype=np.int32, density=0.55, labels=3):
  return ((rng.random(shape) < density) * rng.integers(1, labels + 1, shape)).astype(dtype)


def _snake(shape):
  """A serpentine tube inside each (tz, ty, tx) tile: rows along x on even
  y, joined at alternating ends, planes joined at one corner."""
  T, tz, ty, tx = shape
  y = np.arange(ty)[:, None]
  x = np.arange(tx)[None, :]
  end = np.where((y // 2) % 2 == 0, tx - 1, 0)
  plane = (y % 2 == 0) | (x == end)
  lab = np.zeros(shape, np.int32)
  lab[:, 0::2] = plane
  lab[:, 1::2, 0, 0] = 1
  return lab


# ---------------------------------------------------------------------------
# (a) the plain tile resolve against the Pallas kernel


@pytest.mark.parametrize("kind", ["multilabel", "snake"])
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_resolve_plain_matches_pallas(seed, connectivity, kind):
  rng = np.random.default_rng(seed)
  shape = (6, 4, 8, 16)
  if kind == "snake":
    labt = _snake(shape) * rng.integers(1, 3, (shape[0], 1, 1, 1)).astype(np.int32)
  else:
    labt = _multilabel(rng, shape)
  want = np.asarray(pallas_ccl.tile_resolve(
    jnp.asarray(labt), connectivity, interpret=True
  ))
  got = cuda_ccl.tile_resolve(torch.from_numpy(labt), connectivity)
  assert got.dtype == torch.int32
  assert np.array_equal(got.numpy(), want)


def test_tile_resolve_roots_are_component_minima():
  """Background keeps its own index; every component points at its
  smallest local index."""
  lab = np.zeros((1, 2, 3, 4), np.int32)
  lab[0, 0, 0, 1:3] = 5
  lab[0, 1, 2, 3] = 5
  lab[0, 1, 2, 2] = 7
  out = cuda_ccl.tile_resolve(torch.from_numpy(lab), 6).numpy().reshape(-1)
  idx = np.arange(lab.size)
  fg = lab.reshape(-1) != 0
  assert np.array_equal(out[~fg], idx[~fg])
  assert out[1] == out[2] == 1
  assert out[23] == 23 and out[22] == 22  # 5 and 7 touch but differ


# ---------------------------------------------------------------------------
# (b) connected_components against each backend of the JAX package


def _jax_backend(monkeypatch, backend):
  if backend == "native":
    from igneous_tpu.native import ccl_lib

    assert ccl_lib() is not None, "the native CCL library did not build"
    monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  else:
    monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "device")
    monkeypatch.setenv("IGNEOUS_CCL_ENGINE", backend.split("-")[1])


def _case(name, rng):
  if name == "uint8":
    return _multilabel(rng, (19, 14, 9), np.uint8)
  if name == "uint32":
    return _multilabel(rng, (13, 11, 10), np.uint32, labels=5)
  if name == "uint64_above_2^32":
    lab = _multilabel(rng, (12, 10, 9), np.uint64)
    lab[lab == 3] = np.uint64(2**40 + 7)
    lab[lab == 2] = np.uint64(2**33 + 1)
    return lab
  if name == "negative_int":
    return (rng.integers(-3, 3, (11, 9, 8))).astype(np.int16)
  if name == "no_zero":
    return rng.integers(1, 3, (9, 8, 7)).astype(np.int64)
  if name == "empty":
    return np.zeros((7, 5, 3), np.uint32)
  if name == "one_label":
    return np.full((9, 6, 5), 9, np.uint64)
  if name == "zero_size":
    return np.zeros((0, 4, 3), np.uint8)
  if name == "degenerate_1xnxm":
    return _multilabel(rng, (1, 17, 9), np.uint16)
  if name == "degenerate_nx1x1":
    return _multilabel(rng, (23, 1, 1), np.uint32, density=0.7)
  raise KeyError(name)


CASES = [
  ("uint8", 6), ("uint8", 26), ("uint32", 18), ("uint64_above_2^32", 6),
  ("uint64_above_2^32", 26), ("negative_int", 6), ("no_zero", 26),
  ("empty", 6), ("one_label", 26), ("zero_size", 6),
  ("degenerate_1xnxm", 26), ("degenerate_nx1x1", 6),
]


@pytest.mark.parametrize("case, connectivity", CASES, ids=[f"{c}-{n}" for c, n in CASES])
@pytest.mark.parametrize("backend", ["native", "device-lax", "device-pallas"])
def test_connected_components_matches_reference(monkeypatch, backend, case, connectivity):
  if backend == "device-pallas":
    # the tile does not change the labels; larger tiles keep interpret mode short
    monkeypatch.setenv("IGNEOUS_CCL_TILE", "4,8,16")
  _jax_backend(monkeypatch, backend)
  lab = _case(case, np.random.default_rng(len(case)))
  want, want_n = jax_ccl.connected_components(lab, connectivity, return_N=True)
  monkeypatch.delenv("IGNEOUS_CCL_TILE", raising=False)
  got, got_n = ccl.connected_components(lab, connectivity, return_N=True)
  assert got.dtype == want.dtype and got.shape == want.shape
  assert np.array_equal(got, want)
  assert got_n == want_n


@pytest.mark.parametrize("tile", ["1,2,4", "64,64,64", "3,5,7"])
def test_tile_smaller_and_larger_than_volume(monkeypatch, tile):
  """Tiles that subdivide the volume (and do not divide it) and one tile
  that covers it give the reference's labels."""
  rng = np.random.default_rng(5)
  lab = _multilabel(rng, (12, 10, 8), np.uint32)
  monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  want = jax_ccl.connected_components(lab, 18)
  monkeypatch.setenv("IGNEOUS_CCL_TILE", tile)
  assert np.array_equal(ccl.connected_components(lab, 18), want)


def test_tile_shape_env(monkeypatch):
  assert ccl._tile_shape(torch.device("cpu")) == (2, 4, 8)
  assert ccl._tile_shape(torch.device("cuda")) == ccl._DEFAULT_TILE_CUDA
  assert cuda_ccl.fits_shared_memory(ccl._DEFAULT_TILE_CUDA)
  monkeypatch.setenv("IGNEOUS_CCL_TILE", "4,8,16")
  assert ccl._tile_shape() == (4, 8, 16)
  for bad in ("4,8", "a,b,c", "0,8,16"):
    monkeypatch.setenv("IGNEOUS_CCL_TILE", bad)
    with pytest.raises(ValueError, match="IGNEOUS_CCL_TILE"):
      ccl._tile_shape()


def test_padded_volume_past_int32_raises():
  labels = torch.zeros((1, 1, 1), dtype=torch.int32).expand(1300, 1300, 1300)
  with pytest.raises(ValueError, match="int32"):
    ccl.to_tiles(labels, (8, 16, 32))


@pytest.mark.parametrize("connectivity", [6, 18, 26])
def test_merge_and_renumber_match_reference(connectivity):
  """The host stages alone: the same tile-local roots give the reference's
  merged roots and numbering."""
  rng = np.random.default_rng(connectivity)
  zyx = _multilabel(rng, (10, 9, 13))
  tile = (3, 4, 5)
  roots = ccl._ccl_tiled_roots(torch.from_numpy(zyx), connectivity, tile).numpy()
  want = np.asarray(jax_ccl._ccl_tiled_kernel(
    jnp.asarray(zyx), connectivity, algo="scan", tile=tile, engine="lax"
  ))
  assert np.array_equal(roots, want)
  merged = ccl._merge_tile_roots(roots, zyx, connectivity, tile)
  assert np.array_equal(merged, jax_ccl._merge_tile_roots(want, zyx, connectivity, tile))
  xyz = merged.transpose(2, 1, 0)
  assert np.array_equal(
    ccl._roots_to_components(xyz), jax_ccl._roots_to_components(xyz)
  )


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint64])
def test_dense_relabel_matches_reference(dtype):
  rng = np.random.default_rng(3)
  for lab in (
    rng.integers(0, 4, (6, 5, 4)), rng.integers(1, 4, (6, 5, 4)),
    rng.integers(-2, 3, (6, 5, 4)),
  ):
    if np.dtype(dtype).kind == "u":
      lab = np.abs(lab)
    lab = lab.astype(dtype)
    assert np.array_equal(ccl._dense_relabel(lab), jax_ccl._dense_relabel(lab))


# ---------------------------------------------------------------------------
# (c) dust


@pytest.mark.parametrize("threshold", [0, 1, 3, 8, 1000])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint64])
def test_dust_matches_reference(monkeypatch, threshold, dtype):
  monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  lab = _multilabel(np.random.default_rng(threshold), (14, 12, 9), dtype, density=0.4)
  want = jax_ccl.dust(lab, threshold)
  got = ccl.dust(lab, threshold)
  assert got.dtype == want.dtype and np.array_equal(got, want)
  inplace = lab.copy()
  assert ccl.dust(inplace, threshold, in_place=True) is inplace
  assert np.array_equal(inplace, want)


def test_threshold_image_and_disjoint_set_match_reference():
  img = np.random.default_rng(0).integers(0, 256, (5, 6, 7)).astype(np.uint8)
  for gte, lte in ((None, None), (128, None), (None, 50), (30, 200)):
    assert np.array_equal(
      ccl.threshold_image(img, gte, lte), jax_ccl.threshold_image(img, gte, lte)
    )
  ours, theirs = ccl.DisjointSet(), jax_ccl.DisjointSet()
  for ds in (ours, theirs):
    for a, b in ((5, 9), (11, 9), (20, 21), (3, 3), (40, 2**40)):
      ds.union(a, b)
    ds.makeset(7)
  assert ours.renumber() == theirs.renumber()


# ---------------------------------------------------------------------------
# (d) the wrapper launches the kernel or raises


@pytest.mark.parametrize("dtype, connectivity, shape, exc", [
  (torch.int64, 6, (1, 2, 2, 2), TypeError),
  (torch.uint32, 6, (1, 2, 2, 2), TypeError),
  (torch.int32, 8, (1, 2, 2, 2), ValueError),
  (torch.int32, 6, (2, 2, 2), ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(dtype, connectivity, shape, exc):
  with pytest.raises(exc):
    cuda_ccl.tile_resolve(torch.zeros(shape, dtype=dtype), connectivity)


def test_wrapper_shared_memory_limit():
  """A tile fits while its labels and parents (8 bytes a voxel) fit one
  block's 232,448 bytes; every tile with a compiled instance fits."""
  assert cuda_ccl.fits_shared_memory((1, 1, 232448 // 8))
  assert not cuda_ccl.fits_shared_memory((1, 1, 232448 // 8 + 1))
  assert not cuda_ccl.fits_shared_memory((32, 32, 32))
  assert all(cuda_ccl.fits_shared_memory(t) for t in cuda_ccl.FIXED_TILES)
  assert ccl._DEFAULT_TILE_CUDA in cuda_ccl.FIXED_TILES


@pytest.mark.parametrize("tile, ptrs, fixed", [
  ((16, 16, 32), (0, 4096), True),
  ((8, 16, 64), (256, 512), True),
  ((8, 16, 32), (16, 32), True),
  ((16, 16, 32), (4, 0), False),  # an input that is not 16-byte aligned
  ((16, 16, 32), (0, 8), False),  # an output that is not
  ((3, 5, 7), (0, 0), False),  # a shape without a compiled instance
  ((16, 32, 16), (0, 0), False),
])
def test_wrapper_picks_the_kernel_instance(tile, ptrs, fixed):
  """The instance compiled for the tile shape runs only on 16-byte aligned
  tensors (its loads and stores move 16 bytes a thread); any other shape
  or pointer takes the runtime-shape instance."""
  assert cuda_ccl.fixed_instance(tile, *ptrs) is fixed


def test_wrapper_never_falls_back_for_a_device_tensor():
  """Only a CPU tensor takes the plain version: any other device either
  launches the kernel or raises."""
  x = torch.zeros((2, 4, 8, 16), dtype=torch.int32, device="meta")
  before = dict(cuda_ccl.LAUNCHES)
  with pytest.raises(ValueError, match="CPU or CUDA"):
    cuda_ccl.tile_resolve(x, 6)
  assert cuda_ccl.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_on_the_card_matches_plain_and_raises_without_its_build(
  needs_cuda, monkeypatch
):
  """On the card: the main path launches the kernel, which equals its plain
  version; a CUDA tensor whose kernel cannot be built raises instead of
  running the plain version."""
  from igneous_tpu_torch.ops import _build

  monkeypatch.setenv(device.ENV, "cuda")
  device.reset_device()
  lab = _multilabel(np.random.default_rng(0), (40, 33, 21), np.uint64)
  before = cuda_ccl.LAUNCHES["tile_resolve"]
  monkeypatch.setenv("IGNEOUS_CCL_BACKEND", "native")
  assert np.array_equal(ccl.connected_components(lab, 26), jax_ccl.connected_components(lab, 26))
  assert cuda_ccl.LAUNCHES["tile_resolve"] == before + 1
  labt = torch.from_numpy(_multilabel(np.random.default_rng(1), (5, 16, 16, 32))).cuda()
  assert torch.equal(cuda_ccl.tile_resolve(labt, 6), cuda_ccl.tile_resolve_plain(labt, 6))

  def no_nvcc():
    raise RuntimeError("nvcc not found")

  monkeypatch.setattr(cuda_ccl, "_LIB", None)
  monkeypatch.setattr(_build, "_LIBS", {})
  monkeypatch.setattr(_build, "library_path", lambda name: _build.BUILD_DIR / "missing.so")
  monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
  count = cuda_ccl.LAUNCHES["tile_resolve"]
  with pytest.raises(RuntimeError, match="nvcc"):
    cuda_ccl.tile_resolve(labt, 6)
  assert cuda_ccl.LAUNCHES["tile_resolve"] == count
