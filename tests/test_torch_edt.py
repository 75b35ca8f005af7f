"""The port's multilabel EDT against the JAX package's.

The same labels, made with numpy from a seed, go through
``igneous_tpu.ops.edt.edt`` and ``igneous_tpu_torch.ops.edt.edt``. The
port's contract is the JAX package's host path (``IGNEOUS_EDT_BACKEND=
native``, ``native/csrc/edt.cpp``), bit for bit; on the CPU the port runs
the plain PyTorch version of its ``edt_pass`` kernel. Against the JAX
package's float32 device program and against scipy the results agree
within 1e-3 (the JAX package's own EDT tolerance): those compute in
float32 or in another order.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from igneous_tpu.ops import edt as jax_edt
from igneous_tpu_torch import device
from igneous_tpu_torch.ops import cuda_edt
from igneous_tpu_torch.ops.edt import edt

ATOL = 1e-3  # float32 device program and scipy: the JAX package's tolerance


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


def _labels(kind: str) -> np.ndarray:
  rng = np.random.default_rng(7)
  if kind == "uint8":
    return (rng.integers(0, 3, (22, 18, 14)) * 9).astype(np.uint8)
  if kind == "uint32":
    lab = rng.integers(0, 4, (17, 21, 11)).astype(np.uint32)
    return lab * np.uint32(2**30 + 3)  # ids above 2^31
  if kind == "uint64":
    blobs = ndimage.gaussian_filter(rng.random((33, 29, 31)), 2) > 0.5
    lab = ndimage.label(blobs)[0].astype(np.uint64)
    lab[lab % 2 == 1] += np.uint64(2**63)  # ids at or above 2^63
    lab[~blobs] = 0
    return lab
  if kind == "signed_negative":
    return (rng.integers(-2, 3, (18, 15, 9)) * 7).astype(np.int32)
  if kind == "adversarial_runs":
    # alternating 1-thick slabs, a label wall mid-y and a solid block
    lab = np.zeros((40, 17, 13), np.uint32)
    lab[::2] = 5
    lab[:, :8] += 7
    lab[10:30, 4:12, 3:9] = 11
    return lab
  if kind == "odd_shape":
    blobs = ndimage.gaussian_filter(rng.random((1, 37, 5)), 1) > 0.5
    return np.asfortranarray(blobs.astype(np.uint16) * 3)
  raise ValueError(kind)


KINDS = ["uint8", "uint32", "uint64", "signed_negative", "adversarial_runs", "odd_shape"]
ANISOTROPIES = [(1, 1, 1), (4, 4, 40), (8, 8, 40), (2, 3, 5)]


@pytest.mark.parametrize("black_border", [False, True])
@pytest.mark.parametrize("anisotropy", ANISOTROPIES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_edt_equals_native_bit_for_bit(kind, anisotropy, black_border, monkeypatch):
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  lab = _labels(kind)
  ref = jax_edt.edt(lab, anisotropy, black_border=black_border)
  got = edt(lab, anisotropy, black_border=black_border)
  assert got.dtype == np.float32 and got.shape == lab.shape
  assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
  assert np.all(got[lab == 0] == 0)


def test_plain_version_in_line_chunks_is_the_same(monkeypatch):
  """The plain envelope runs in chunks of lines; any chunk is the same."""
  lab = _labels("uint64")
  whole = edt(lab, (4, 4, 40))
  monkeypatch.setitem(cuda_edt._PLAIN_LINES, "cpu", 7)
  assert np.array_equal(edt(lab, (4, 4, 40)).view(np.uint32), whole.view(np.uint32))


def _scipy_multilabel(labels, anisotropy):
  out = np.zeros(labels.shape, np.float32)
  for v in np.unique(labels):
    if v == 0:
      continue
    d = ndimage.distance_transform_edt(labels == v, sampling=anisotropy)
    out[labels == v] = d[labels == v]
  return out


@pytest.mark.parametrize("anisotropy", [(1, 1, 1), (4, 4, 40)], ids=str)
@pytest.mark.parametrize("kind", ["uint64", "adversarial_runs", "signed_negative"])
def test_edt_against_device_program_and_scipy(kind, anisotropy, monkeypatch):
  lab = _labels(kind)
  got = edt(lab, anisotropy)
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "device")
  dev = jax_edt.edt(lab, anisotropy)
  assert np.allclose(got, dev, atol=ATOL)
  assert np.allclose(got, _scipy_multilabel(lab, anisotropy), atol=ATOL)


def test_edt_pass_checks_its_arguments():
  lab = torch.zeros((4, 5, 6), dtype=torch.int64)
  val = torch.zeros((4, 5, 6), dtype=torch.float32)
  with pytest.raises(ValueError, match="distinct"):
    cuda_edt.edt_pass(lab, val, val, 1, 1.0, False)
  with pytest.raises(ValueError, match="int32 or int64"):
    cuda_edt.edt_pass(lab.to(torch.int16), val, val, 0, 1.0, True)
  with pytest.raises(ValueError, match="axis"):
    cuda_edt.edt_pass(lab, val, val, 3, 1.0, True)
  with pytest.raises(ValueError, match="float32"):
    cuda_edt.edt_pass(lab, val.double(), val.double(), 0, 1.0, True)


def test_plain_version_does_not_count_launches():
  before = cuda_edt.LAUNCHES["edt_pass"]
  edt(_labels("uint8"), (1, 1, 1))
  assert cuda_edt.LAUNCHES["edt_pass"] == before


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  dev = torch.device("cuda")
  lab = torch.from_numpy(np.ascontiguousarray(_labels("uint64").view(np.int64))).to(dev)
  for axis in (0, 1, 2):
    val = torch.rand(lab.shape, device=dev) * 100
    for first in (True, False):
      got = cuda_edt.edt_pass(lab, val, torch.empty_like(val), axis, 3.0, first)
      ref = cuda_edt.edt_pass_plain(lab, val, torch.empty_like(val), axis, 3.0, first)
      assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
