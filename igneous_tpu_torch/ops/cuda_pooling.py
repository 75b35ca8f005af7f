"""2x2x1 average / mode pooling on (c, z, y, x) tensors: CUDA kernels and
their plain PyTorch versions.

Counterpart of ``igneous_tpu/ops/pallas_pooling.py``. Its two Pallas
kernels become the two hand-written CUDA kernels of ``csrc/pooling.cu``:

  ``pool2x2x1``     one 2x2x1 step, edge-replicate at odd extents
                    (replaces ``_pool_zlast``);
  ``pyramid2x2x1``  the fused L-level walk, one read of the input for every
                    level (replaces ``_pyramid_zlast``).

Each wrapper takes its plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts kernel launches, one per launch and nowhere else. The device
ledger's execute span (``observability.device``) goes around each launch
and each plain call, under the kernel's name.

Types: average on 8- and 16-bit integers (an int32 sum is exact there);
mode on 8-, 16-, 32- and 64-bit integers. The sums and votes are those of
the Pallas kernels, so every output is bit for bit theirs.
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from ..observability.device import execute_span
from . import _build

LAUNCHES = {"pool2x2x1": 0, "pyramid2x2x1": 0}

_AVG_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3}
_MODE_CODES = {
  torch.uint8: 0, torch.int8: 0, torch.uint16: 2, torch.int16: 2,
  torch.uint32: 4, torch.int32: 4, torch.uint64: 5, torch.int64: 5,
}
_METHOD_CODES = {"average": 0, "mode": 1}
# PyTorch implements little beyond copies on uint16/32/64 (on CUDA not even
# torch.where); the plain versions compare and select on the signed view of
# the same bits, which keeps equality
SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def supports(method: str, dtype: torch.dtype) -> bool:
  """True when the kernels take ``method`` on ``dtype``."""
  if method == "average":
    return dtype in _AVG_CODES
  if method == "mode":
    return dtype in _MODE_CODES
  return False


def row_vector_bytes(width: int, itemsize: int, in_ptr: int, out_ptr: int) -> int:
  """Bytes of each input row that one ``pool2x2x1`` thread reads at once:
  the widest of 16, 8 and 4 that holds two elements or more, divides the
  row's length in bytes and aligns both pointers (the input to it, the
  output to half of it); 0, the element-wise path, where none does (odd
  widths among them)."""
  for v in (16, 8, 4):
    if (v >= 2 * itemsize and (width * itemsize) % v == 0
        and in_ptr % v == 0 and out_ptr % (v // 2) == 0):
      return v
  return 0


def fused_aligned(shape, levels: int) -> bool:
  """The fused walk runs when y and x are multiples of 2**levels: then no
  level's extent goes odd and one read of the input serves every level.
  Other extents iterate the single step, as the Pallas wrapper does."""
  return shape[-2] % (1 << levels) == 0 and shape[-1] % (1 << levels) == 0


def tile_size(levels: int, itemsize: int) -> int:
  """Edge S of the S x S tiles the fused kernel's blocks walk: 256 for
  8-bit data, 128 for 16-bit, 64 wider (picked by timing 64..512 at the
  main path's shapes on an H100), and at least 2**levels."""
  return max(1 << levels, {1: 256, 2: 128}.get(itemsize, 64))


def fused_smem_bytes(levels: int, itemsize: int) -> int:
  """Shared memory of one fused block: the level-1 tile and the level-2
  tile it ping-pongs with."""
  s = tile_size(levels, itemsize)
  return ((s // 2) ** 2 + (s // 4) ** 2) * itemsize


def max_fused_levels(itemsize: int) -> int:
  """Most levels one fused launch takes within one block's shared memory."""
  levels = 1
  while levels < 16 and fused_smem_bytes(levels + 1, itemsize) <= _SMEM_LIMIT:
    levels += 1
  return levels


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the yardstick on the card)


def _pad_even(x: torch.Tensor) -> torch.Tensor:
  """Edge-replicate y and x to even extents (exact for factor 2)."""
  if x.dtype in SIGNED_VIEW:
    return _pad_even(x.view(SIGNED_VIEW[x.dtype])).view(x.dtype)
  if x.shape[-2] % 2:
    x = torch.cat([x, x[..., -1:, :]], dim=-2)
  if x.shape[-1] % 2:
    x = torch.cat([x, x[..., :, -1:]], dim=-1)
  return x


def pool2x2x1_plain(x: torch.Tensor, method: str = "average") -> torch.Tensor:
  """One 2x2x1 step in plain PyTorch: strided slices, an int32 sum and
  floor division for average, pairwise equality and ``torch.where`` for
  mode. Unsigned 16/32/64-bit tensors are widened for the sum and voted on
  as their signed views."""
  _check(x, method)
  if method == "mode" and x.dtype in SIGNED_VIEW:
    return pool2x2x1_plain(x.view(SIGNED_VIEW[x.dtype]), method).view(x.dtype)
  x = _pad_even(x)
  vs = [x[..., 0::2, 0::2], x[..., 0::2, 1::2],
        x[..., 1::2, 0::2], x[..., 1::2, 1::2]]
  if method == "average":
    s = sum(v.to(torch.int32) for v in vs) + 2
    return torch.div(s, 4, rounding_mode="floor").to(x.dtype)
  best_s = best_v = None
  for i in range(4):
    counts = sum((vs[i] == vs[j]).to(torch.int32) for j in range(4))
    score = counts * 4 - i
    if best_s is None:
      best_s, best_v = score, vs[i]
    else:
      take = score > best_s
      best_s = torch.where(take, score, best_s)
      best_v = torch.where(take, vs[i], best_v)
  return best_v.contiguous()


def pyramid2x2x1_plain(
  x: torch.Tensor, levels: int, method: str = "average"
) -> List[torch.Tensor]:
  """``levels`` plain 2x2x1 steps, one tensor per level."""
  outs = []
  for _ in range(levels):
    x = pool2x2x1_plain(x, method)
    outs.append(x)
  return outs


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(x: torch.Tensor, method: str) -> None:
  if method not in _METHOD_CODES:
    raise ValueError(f"2x2x1 pooling kernels take average or mode, not {method!r}")
  if not supports(method, x.dtype):
    raise TypeError(
      f"2x2x1 {method} pooling takes "
      f"{'8/16-bit' if method == 'average' else '8/16/32/64-bit'} integers, "
      f"not {x.dtype}"
    )
  if x.dim() < 2:
    raise ValueError(f"expected a (..., y, x) tensor, got shape {tuple(x.shape)}")


_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    lib = _build.load("pooling")
    lib.igt_pool2x2x1.argtypes = [
      ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
      ctypes.c_void_p,
    ]
    lib.igt_pool2x2x1.restype = ctypes.c_int
    lib.igt_pyramid2x2x1.argtypes = [
      ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.igt_pyramid2x2x1.restype = ctypes.c_int
    lib.igt_error_string.argtypes = [ctypes.c_int]
    lib.igt_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def _raise_on(rc: int, what: str) -> None:
  if rc != 0:
    msg = _lib().igt_error_string(rc).decode()
    raise RuntimeError(f"{what} kernel failed: CUDA error {rc} ({msg})")


def _cuda_input(x: torch.Tensor, method: str):
  _check(x, method)
  if x.device.type != "cuda":
    raise ValueError(f"pooling kernels take CPU or CUDA tensors, not {x.device}")
  if not x.is_contiguous():
    raise ValueError("pooling kernels take C-contiguous (c, z, y, x) tensors")
  codes = _AVG_CODES if method == "average" else _MODE_CODES
  Y, X = x.shape[-2], x.shape[-1]
  P = x.numel() // (Y * X) if Y * X else 0
  return codes[x.dtype], P, Y, X


def _span(name: str, x: torch.Tensor, method: str, out_elements: int):
  """The ledger's execute span of one launch or plain call on ``x``."""
  nbytes = (x.numel() + out_elements) * x.element_size()
  sig = (tuple(x.shape), str(x.dtype), method)
  return execute_span(name, x.numel(), nbytes, x.device, signature=sig)


def pool2x2x1(x: torch.Tensor, method: str = "average") -> torch.Tensor:
  """One 2x2x1 step: (..., Y, X) -> (..., ceil(Y/2), ceil(X/2))."""
  if x.device.type == "cpu":
    _check(x, method)
    with _span("pool2x2x1", x, method, x.numel() // 4):
      return pool2x2x1_plain(x, method)
  code, P, Y, X = _cuda_input(x, method)
  out = torch.empty(
    x.shape[:-2] + ((Y + 1) // 2, (X + 1) // 2), dtype=x.dtype, device=x.device
  )
  if out.numel() == 0:
    return out
  lib = _lib()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vec = row_vector_bytes(X, x.element_size(), x.data_ptr(), out.data_ptr())
    with _span("pool2x2x1", x, method, out.numel()):
      rc = lib.igt_pool2x2x1(
        _METHOD_CODES[method], code, x.data_ptr(), out.data_ptr(), P, Y, X, vec,
        stream,
      )
      _raise_on(rc, "pool2x2x1")
  LAUNCHES["pool2x2x1"] += 1
  return out


def _pyramid_launch(x: torch.Tensor, levels: int, method: str) -> List[torch.Tensor]:
  code, P, Y, X = _cuda_input(x, method)
  outs = [
    torch.empty(x.shape[:-2] + (Y >> l, X >> l), dtype=x.dtype, device=x.device)
    for l in range(1, levels + 1)
  ]
  if x.numel() == 0:
    return outs
  item = x.element_size()
  S = tile_size(levels, item)
  vec = int((X * item) % 16 == 0 and all(
    t.data_ptr() % 16 == 0 for t in [x] + outs
  ))
  ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in outs])
  lib = _lib()
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with _span("pyramid2x2x1", x, method, sum(o.numel() for o in outs)):
      rc = lib.igt_pyramid2x2x1(
        _METHOD_CODES[method], code, x.data_ptr(), ptrs, levels, P, Y, X, S,
        vec, stream,
      )
      _raise_on(rc, "pyramid2x2x1")
  LAUNCHES["pyramid2x2x1"] += 1
  return outs


def pyramid2x2x1(
  x: torch.Tensor, levels: int, method: str = "average"
) -> List[torch.Tensor]:
  """``levels`` 2x2x1 steps, one tensor per level, bit for bit what
  ``levels`` ``pool2x2x1`` calls give. On the card, aligned extents
  (``fused_aligned``) take the fused kernel, one launch per
  ``max_fused_levels`` levels; other extents iterate ``pool2x2x1``."""
  if levels < 1:
    raise ValueError("levels must be >= 1")
  if x.device.type == "cpu":
    _check(x, method)
    out_elements = sum(x.numel() >> (2 * l) for l in range(1, levels + 1))
    with _span("pyramid2x2x1", x, method, out_elements):
      return pyramid2x2x1_plain(x, levels, method)
  if not fused_aligned(x.shape, levels):
    outs = []
    for _ in range(levels):
      x = pool2x2x1(x, method)
      outs.append(x)
    return outs
  step = max_fused_levels(x.element_size())
  outs = []
  while len(outs) < levels:
    outs += _pyramid_launch(x, min(step, levels - len(outs)), method)
    x = outs[-1]
  return outs
