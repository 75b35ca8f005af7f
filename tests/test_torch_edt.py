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


def test_distance_is_the_correctly_rounded_root(monkeypatch):
  """The distance 14^2 + 35^2 = 1421 away is sqrt(1421) rounded once to
  float32, as the host path's np.sqrt gives it."""
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  lab = np.ones((15, 36, 1), np.uint32)
  lab[0, 0, 0] = 0
  got = edt(lab, (1, 1, 1))
  assert got[14, 35, 0] == np.sqrt(np.float32(1421))
  assert np.array_equal(got.view(np.uint32), jax_edt.edt(lab, (1, 1, 1)).view(np.uint32))


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


# ---------------------------------------------------------------------------
# a model of the kernel's line scheme (csrc/edt.cu, edt_lines_kernel)

_INF = cuda_edt.INF
_SKIP = _INF * 0.5
_FAR = 1e30


def _bits(flags) -> list:
  """Booleans by position -> 32-bit words, bit p % 32 of word p // 32."""
  words = [0] * ((len(flags) + 31) // 32)
  for p, f in enumerate(flags):
    if f:
      words[p >> 5] |= 1 << (p & 31)
  return words


def _next_bit(words, p: int, lim: int) -> int:
  """The lowest set bit above p and below lim, or -1 (the kernel's
  next_bit, word by word)."""
  x = p + 1
  if x >= lim:
    return -1
  w = x >> 5
  m = words[w] & ((0xFFFFFFFF << (x & 31)) & 0xFFFFFFFF)
  while m == 0:
    w += 1
    if w > (lim - 1) >> 5:
      return -1
    m = words[w]
  r = (w << 5) + (m & -m).bit_length() - 1
  return r if r < lim else -1


def _prev_bit(words, v: int, lo: int) -> int:
  """The highest set bit below v and at or above lo, or -1 (prev_bit)."""
  if v <= lo:
    return -1
  w = v >> 5
  m = words[w] & ((1 << (v & 31)) - 1) if v & 31 else 0
  while m == 0:
    w -= 1
    if w < lo >> 5:
      return -1
    m = words[w]
  r = (w << 5) + m.bit_length() - 1
  return r if r >= lo else -1


def _edge(q, a, b1, n, w2) -> np.float32:
  dl = float(q - a + 1) if a > 0 else _FAR
  dr = float(b1 - q) if b1 < n else _FAR
  d = min(dl, dr)
  e = d * d * w2 if d < 1e29 else _INF
  return np.float32(min(_INF, e))


def _bound(v0, h0, v1, h1) -> float:
  return ((h1 + float(v1 * v1)) - (h0 + float(v0 * v0))) / float(2 * (v1 - v0))


def _model_build(lab, val, w2: float, first: bool):
  """The kernel's staging and build for one line, in Python doubles (each
  operation rounded to nearest, as the kernel's intrinsics): the run
  starts and the stacks as bitmasks, one position loop with the stack top
  and the entry below it in registers, a popped entry's neighbour found
  with prev_bit, heights recomputed from the values and bounds from
  neighbouring entries. Returns (run starts, stacks, values)."""
  n = len(lab)
  chg = _bits([p == 0 or lab[p] != lab[p - 1] for p in range(n)])
  stk = [0] * len(chg)
  vals = [float(np.float32(v)) for v in val]
  if first:
    return chg, stk, vals
  a, v1, v0, h1, h0, z1 = 0, -1, -1, 0.0, 0.0, -_FAR
  for q in range(n):
    if chg[q >> 5] >> (q & 31) & 1:
      a, v1 = q, -1
    fq = vals[q]
    if fq >= _SKIP:
      continue
    fq = fq / w2
    fq_q2 = fq + float(q * q)
    s = -_FAR
    while v1 >= 0:
      s = (fq_q2 - (h1 + float(v1 * v1))) / float(2 * (q - v1))
      if not s <= z1:
        break
      stk[v1 >> 5] &= ~(1 << (v1 & 31))
      v1, h1 = v0, h0
      if v1 >= 0:
        v0 = _prev_bit(stk, v1, a)
        if v0 >= 0:
          h0 = vals[v0] / w2
          z1 = _bound(v0, h0, v1, h1)
        else:
          z1 = -_FAR
    if v1 < 0:
      s = -_FAR
    stk[q >> 5] |= 1 << (q & 31)
    v0, h0, v1, h1, z1 = v1, h1, q, fq, s
  return chg, stk, vals


def _model_line(lab, val, w2: float, first: bool) -> np.ndarray:
  """One line through the kernel's scheme: ``_model_build``, then the
  query loop, which finds each run's end and first entry from the
  bitmasks and advances through its entries with next_bit."""
  n = len(lab)
  chg, stk, vals = _model_build(lab, val, w2, first)
  out = np.empty(n, np.float32)
  a, b1, vj, vn, hj, hn, zn = 0, n, -1, -1, 0.0, 0.0, 0.0
  for q in range(n):
    if chg[q >> 5] >> (q & 31) & 1:
      a = q
      r = _next_bit(chg, q, n)
      b1 = n if r < 0 else r
      if not first:
        vj, vn = _next_bit(stk, a - 1, b1), -1
        if vj >= 0:
          hj = vals[vj] / w2
          vn = _next_bit(stk, vj, b1)
          if vn >= 0:
            hn = vals[vn] / w2
            zn = _bound(vj, hj, vn, hn)
    o = _edge(q, a, b1, n, w2)
    if not first and vj >= 0:
      while vn >= 0 and zn < float(q):
        vj, hj = vn, hn
        vn = _next_bit(stk, vj, b1)
        if vn >= 0:
          hn = vals[vn] / w2
          zn = _bound(vj, hj, vn, hn)
      env = (hj + float((q - vj) * (q - vj))) * w2
      if env < float(o):
        o = np.float32(env)
    out[q] = o
  return out


def _model_pass(lab: np.ndarray, val: np.ndarray, axis: int, w: float, first: bool):
  """The model along every line of ``axis`` of a 3-d array."""
  lab_l = np.moveaxis(lab, axis, -1)
  val_l = np.moveaxis(val, axis, -1)
  out = np.empty(lab_l.shape, np.float32)
  for idx in np.ndindex(lab_l.shape[:-1]):
    out[idx] = _model_line(lab_l[idx].tolist(), val_l[idx], float(w) * float(w), first)
  return np.moveaxis(out, -1, axis)


def _model_edt(labels: np.ndarray, anisotropy) -> np.ndarray:
  """``ops.edt.edt`` with the model in place of ``edt_pass``: passes along
  x (first), y and z of the (x, y, z) labels' raw 32- or 64-bit ids."""
  from igneous_tpu_torch.ops.edt import host_labels

  lab = host_labels(labels)
  sq = np.zeros(lab.shape, np.float32)
  for axis in (0, 1, 2):
    sq = _model_pass(lab, sq, axis, anisotropy[axis], axis == 0)
  out = np.sqrt(sq, dtype=np.float32)
  out[labels == 0] = 0
  return out


_SKIP32 = np.float32(_SKIP)


def _line_cases():
  """(name, labels, values) lines that reach every branch of the scheme."""
  rng = np.random.default_rng(11)
  n = 70  # three words of run starts and stacks, the last one partial
  near_skip = [np.nextafter(_SKIP32, np.float32(0)), _SKIP32, np.nextafter(_SKIP32, np.float32(np.inf))]
  big = np.int64(np.uint64(2**63 + 5).view(np.int64))
  return [
    # equal heights: every position of the run stays on the stack
    ("worst depth, one run", np.full(n, 3, np.int64), np.full(n, 4.0, np.float32)),
    ("worst depth, two runs", np.repeat([1, 2], n // 2).astype(np.int64),
     np.full(n, 9.0, np.float32)),
    ("alternating labels", np.arange(n) % 2, rng.random(n).astype(np.float32) * 50),
    ("one label over the line", np.full(n, 7, np.int32), rng.random(n).astype(np.float32) * 500),
    ("values at and above 5e19", rng.integers(0, 2, n).repeat(1),
     np.where(rng.random(n) < 0.5, np.float32(_INF), rng.random(n) * 30).astype(np.float32)),
    ("values around the skip threshold", np.zeros(12, np.int64),
     np.array(near_skip * 2 + [1.0, 2.0, 0.0, 5.0, 1e19, 3.0], np.float32)),
    ("n = 1", np.array([4], np.int64), np.array([2.5], np.float32)),
    ("n = 2, one run", np.array([4, 4], np.int64), np.array([9.0, 0.0], np.float32)),
    ("n = 2, two runs", np.array([4, 5], np.int64), np.array([9.0, 0.0], np.float32)),
    ("int64 labels at or above 2^63", np.array([big, big, 0, big, big + 1, big + 1] * 8, np.int64),
     rng.random(48).astype(np.float32) * 80),
    ("int32 labels", rng.integers(-3, 3, n).astype(np.int32), rng.random(n).astype(np.float32) * 200),
    ("random runs and pops", rng.integers(0, 3, n).repeat(1) // 2,
     (rng.random(n) ** 3 * 400).astype(np.float32)),
  ]


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("w", [1.0, 8.0, 0.3])
@pytest.mark.parametrize("case", range(12), ids=lambda i: _line_cases()[i][0])
def test_line_model_equals_plain_version(case, w, first):
  """The kernel's scheme, line by line, equals ``edt_pass_plain`` bit for
  bit: the same line as a (1, 1, n) volume along the contiguous axis."""
  _, lab, val = _line_cases()[case]
  got = _model_line(lab.tolist(), val, w * w, first)
  t_lab = torch.from_numpy(np.ascontiguousarray(lab).reshape(1, 1, -1))
  t_val = torch.from_numpy(np.ascontiguousarray(val).reshape(1, 1, -1))
  ref = cuda_edt.edt_pass_plain(t_lab, t_val, torch.empty_like(t_val), 2, w, first)
  assert np.array_equal(got.view(np.uint32), ref.numpy().reshape(-1).view(np.uint32))


def test_line_model_reaches_the_worst_stack_depth():
  """Equal heights over a run leave every position on its stack (the
  deepest stack a line can have); concave heights leave the two ends. The bit searches cross word boundaries both ways."""
  n = 70
  _, stk, _ = _model_build([3] * n, np.full(n, 4.0, np.float32), 1.0, False)
  assert stk == _bits([True] * n)
  # heights whose second difference is below -2: each push pops the top
  concave = (4000 - 3 * (np.arange(n) - 35.0) ** 2).astype(np.float32)
  _, stk, _ = _model_build([3] * n, concave, 1.0, False)
  assert sum(bin(w).count("1") for w in stk) == 2
  out = _model_line([3] * n, np.full(n, 4.0, np.float32), 1.0, False)
  assert np.array_equal(out, np.full(n, 4.0, np.float32))
  words = _bits([True] * n)
  assert _next_bit(words, -1, n) == 0 and _prev_bit(words, n - 1, 0) == n - 2
  assert _next_bit(words, 31, n) == 32 and _prev_bit(words, 32, 0) == 31
  assert _next_bit(words, n - 1, n) == -1 and _prev_bit(words, 0, 0) == -1


def _model_volumes():
  rng = np.random.default_rng(5)
  big = np.uint64(2**63)
  x_only = np.broadcast_to(rng.integers(1, 4, (13, 1, 1)), (13, 9, 11)).astype(np.uint32)
  alternating = (np.indices((10, 9, 8)).sum(0) % 2 + 1).astype(np.uint8)
  blocks = rng.integers(0, 3, (7, 6, 9)).astype(np.uint64) * (big + np.uint64(3))
  return {
    # labels that vary along x alone: every y and z line is one run of
    # equal heights, so every position is a stack entry
    "worst depth": x_only,
    "alternating": alternating,
    "one label": np.full((6, 7, 9), 5, np.uint16),  # edge terms 1e20, skipped
    "n = 1 and 2": rng.integers(0, 3, (1, 2, 9)).astype(np.int32),
    "uint64 at or above 2^63": blocks,
    "int32 ids above 2^31": (rng.integers(0, 3, (9, 8, 7)) * (2**31 + 9)).astype(np.uint32),
  }


@pytest.mark.parametrize("anisotropy", [(1, 1, 1), (8, 8, 40)], ids=str)
@pytest.mark.parametrize("kind", list(_model_volumes()))
def test_line_model_edt_equals_native(kind, anisotropy, monkeypatch):
  """The three passes of the model equal the JAX package's native host EDT
  (and the port's EDT on the CPU) bit for bit."""
  monkeypatch.setenv("IGNEOUS_EDT_BACKEND", "native")
  lab = _model_volumes()[kind]
  got = _model_edt(lab, anisotropy)
  ref = jax_edt.edt(lab, anisotropy)
  assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
  assert np.array_equal(got.view(np.uint32), edt(lab, anisotropy).view(np.uint32))


def test_long_line_path_is_chosen_from_the_shape():
  """The shared-memory design takes every pass of the default skeleton
  task's field with no device scratch; lines above the shared-memory
  threshold take the long-line kernel, after the first pass, or in a
  first pass along a strided axis above twice that."""
  field = (515, 515, 515)
  assert not any(cuda_edt.long_line(field, a, f) for a in range(3) for f in (True, False))
  assert max(cuda_edt.scratch_bytes(field, a) for a in range(3)) == 0
  assert cuda_edt.smem_bytes(515, 515, False) == 17 * 128 * 8  # two bitmasks, 128 lines
  assert cuda_edt.smem_bytes(515, 1, True) == 4 * 2 * 17 * 4  # the edge-row kernel
  assert cuda_edt.smem_bytes(7264, 2, False) == cuda_edt.SMEM_BUDGET
  assert cuda_edt.long_line((7265, 2, 2), 0, False)
  assert not cuda_edt.long_line((7264, 2, 2), 0, False)
  assert not cuda_edt.long_line((7265, 2, 2), 0, True)
  assert cuda_edt.long_line((14529, 2, 2), 0, True)
  assert cuda_edt.long_line((8192, 32, 32), 0, False)
  assert cuda_edt.scratch_bytes((8192, 32, 32), 0) == 32 * 32 * (20 * 8192 + 8)
  assert cuda_edt.scratch_bytes((8192, 32, 32), 0, True) == 0
  assert not cuda_edt.long_line((64, 64, 8192), 2, True)  # the edge-row kernel
  assert cuda_edt.long_line((64, 64, 8192), 2, False)


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  dev = torch.device("cuda")
  lab = torch.from_numpy(np.ascontiguousarray(_labels("uint64").view(np.int64))).to(dev)
  # lines longer than the shared-memory threshold along z and along x
  g = torch.Generator(device=dev).manual_seed(3)
  long_z = torch.randint(0, 3, (7400, 3, 33), device=dev, generator=g)
  long_x = torch.randint(0, 2, (3, 5, 7400), device=dev, generator=g).to(torch.int32)
  assert cuda_edt.long_line(long_z.shape, 0, False) and cuda_edt.long_line(long_x.shape, 2, False)
  for labels in (lab, long_z, long_x):
    for axis in (0, 1, 2):
      val = torch.rand(labels.shape, device=dev, generator=g) * 100
      for first in (True, False):
        got = cuda_edt.edt_pass(labels, val, torch.empty_like(val), axis, 3.0, first)
        ref = cuda_edt.edt_pass_plain(labels, val, torch.empty_like(val), axis, 3.0, first)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
