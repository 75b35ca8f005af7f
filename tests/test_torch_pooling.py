"""The port's 2x2x1 pooling kernels' plain versions against the JAX
package's Pallas kernels (run in interpret mode), bit for bit.

On the CPU the wrappers ``pool2x2x1``/``pyramid2x2x1`` take the plain
PyTorch versions; the CUDA kernels themselves are held against those same
plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from igneous_tpu.ops import pallas_pooling
from igneous_tpu.ops import pooling as jax_pooling
from igneous_tpu_torch import device
from igneous_tpu_torch.ops import cuda_pooling


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv("IGNEOUS_TORCH_DEVICE", "cpu")
  device.reset_device()
  yield
  device.reset_device()


def _to_device_layout(img: np.ndarray) -> torch.Tensor:
  """(x, y, z) numpy -> (1, z, y, x) tensor."""
  return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 1, 0)))[None]


def _from_device_layout(t: torch.Tensor) -> np.ndarray:
  return t[0].numpy().transpose(2, 1, 0)


CASES = [
  ("average", np.uint8, 0, 256),
  ("average", np.int16, -300, 300),  # negative sums: floor, not truncation
  ("mode", np.uint16, 0, 4),
  ("mode", np.uint32, 0, 4),
]
SHAPES = [(64, 64, 8), (33, 17, 5), (100, 70, 3)]  # aligned and ragged


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method,dtype,lo,hi", CASES)
def test_plain_matches_pallas(method, dtype, lo, hi, shape):
  rng = np.random.default_rng(7)
  img = rng.integers(lo, hi, shape).astype(dtype)
  t = _to_device_layout(img)

  ref = pallas_pooling.pool2x2x1(img, method=method, interpret=True)
  out = _from_device_layout(cuda_pooling.pool2x2x1(t, method))
  assert out.dtype == ref.dtype and np.array_equal(out, ref)

  levels = 3
  refs = pallas_pooling.pyramid2x2x1(img, levels, method=method, interpret=True)
  outs = cuda_pooling.pyramid2x2x1(t, levels, method)
  assert len(outs) == levels
  for r, o in zip(refs, outs):
    assert np.array_equal(_from_device_layout(o), r)


@pytest.mark.parametrize("method,dtype,labels", [
  ("average", np.int8, None),
  ("mode", np.int32, None),
  ("mode", np.uint64, 2**40),  # labels above 2^32: the reference's hi/lo planes
  ("mode", np.int64, -(2**40)),
])
def test_plain_matches_reference_pyramid_beyond_pallas_dtypes(method, dtype, labels):
  """The kernels take dtypes the Pallas wrappers refuse (int8 average,
  64-bit mode); those are held against ops.pooling's XLA pyramid."""
  rng = np.random.default_rng(11)
  if labels is None:
    info = np.iinfo(dtype)
    img = rng.integers(max(info.min, -128), min(info.max, 127), (48, 40, 4))
  else:
    img = rng.integers(0, 3, (48, 40, 4)) * labels + labels
  img = img.astype(dtype)
  refs = jax_pooling.downsample(img, (2, 2, 1), 3, method=method)
  outs = cuda_pooling.pyramid2x2x1(_to_device_layout(img), 3, method)
  for r, o in zip(refs, outs):
    assert np.array_equal(_from_device_layout(o), r)


def test_mode_tie_order():
  """All four distinct: the first position wins; two pairs: the pair that
  holds the earliest position wins."""
  x = torch.tensor([[[[5, 6], [7, 8]]], [[[3, 9], [9, 3]]]], dtype=torch.uint64)
  assert cuda_pooling.pool2x2x1(x[:, 0], "mode").flatten().tolist() == [5, 3]


@pytest.mark.parametrize("method,dtype,exc", [
  ("average", torch.int32, TypeError),
  ("average", torch.float32, TypeError),
  ("mode", torch.float32, TypeError),
  ("max", torch.uint8, ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(method, dtype, exc):
  x = torch.zeros((1, 1, 4, 4), dtype=dtype)
  with pytest.raises(exc):
    cuda_pooling.pool2x2x1(x, method)
  with pytest.raises(exc):
    cuda_pooling.pyramid2x2x1(x, 2, method)


@pytest.mark.parametrize("width, itemsize, in_ptr, out_ptr, vec", [
  (1000, 1, 0, 0, 8),  # the ragged task's first level: 1000 bytes a row
  (500, 1, 0, 0, 4),
  (999, 1, 0, 0, 0),  # odd widths take the element-wise path
  (1000, 2, 0, 0, 16),
  (999, 2, 0, 0, 0),
  (1000, 4, 0, 0, 16),
  (1000, 8, 0, 0, 16),  # 16 bytes hold two 64-bit elements, 8 do not
  (2, 8, 0, 0, 16),
  (1, 8, 0, 0, 0),
  (1000, 1, 8, 0, 8),  # the input aligned to 8 bytes only
  (1000, 1, 4, 0, 4),
  (1000, 1, 1, 0, 0),
  (1000, 2, 0, 4, 8),  # the output aligned to 4 bytes only
  (1000, 2, 0, 2, 4),
])
def test_pool_row_vector_bytes(width, itemsize, in_ptr, out_ptr, vec):
  """The widest chunk of a row that one pool2x2x1 thread reads with one
  load: at least two elements, dividing the row's bytes, with the input
  aligned to it and the output to half of it."""
  assert cuda_pooling.row_vector_bytes(width, itemsize, in_ptr, out_ptr) == vec


def test_wrappers_never_fall_back_for_a_device_tensor():
  """Only a CPU tensor takes the plain version: any other device either
  launches the kernel or raises."""
  x = torch.zeros((1, 1, 8, 8), dtype=torch.uint8, device="meta")
  before = dict(cuda_pooling.LAUNCHES)
  with pytest.raises(ValueError, match="CPU or CUDA"):
    cuda_pooling.pool2x2x1(x, "average")
  with pytest.raises(ValueError, match="CPU or CUDA"):
    cuda_pooling.pyramid2x2x1(x, 2, "average")
  assert cuda_pooling.LAUNCHES == before


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
def test_fused_tiles_fit_shared_memory(itemsize):
  top = cuda_pooling.max_fused_levels(itemsize)
  assert top >= 5  # the main path's 5 uint8 and 4 uint64 levels fit in one launch
  for levels in range(1, top + 1):
    s = cuda_pooling.tile_size(levels, itemsize)
    assert s % (1 << levels) == 0 and (s * itemsize) % 16 == 0
    assert cuda_pooling.fused_smem_bytes(levels, itemsize) <= 232448


def test_library_name_follows_the_source_text(tmp_path, monkeypatch):
  """A library built from other source text (or other flags) has another
  name, so a stale build is never loaded whatever the files' mtimes."""
  from igneous_tpu_torch.ops import _build

  monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
  src = tmp_path / "pooling.cu"
  src.write_text("// one version\n")
  first = _build.library_path("pooling")
  assert first.parent == _build.BUILD_DIR and first.name.startswith("libpooling-")
  assert _build.library_path("pooling") == first
  src.write_text("// another version\n")
  second = _build.library_path("pooling")
  assert second != first
  monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
  assert _build.library_path("pooling") not in (first, second)
