"""Multi-mip pooling on the port's device: the downsample pyramid.

Counterpart of ``igneous_tpu/ops/pooling.py``, with the same exact
semantics (mirrored bit for bit, float paths included):
  - average on integers: per-mip sum then round-half-up division;
    <=16-bit integers sum in int32; 32-bit integers with power-of-two
    windows are exact; other 32-bit windows and all 64-bit inputs go
    through float32, as the reference does;
  - mode: majority value, ties to the earliest window position (z-major,
    then y, then x); sparse ignores zeros unless the window is all zero.
    64-bit labels are compared as 64-bit words (the reference splits them
    into uint32 planes; equality distributes over the split);
  - odd extents are edge-replicated to the next multiple of the factor.

Layout on the device is (c, z, y, x). Routing (``route``): the leading run
of (2, 2, 1) factors, for average on <=16-bit integers or non-sparse mode
on integers, goes to ``cuda_pooling.pyramid2x2x1`` (which takes the fused
kernel when x and y are multiples of 2**run, else iterates the single
step); every other factor runs the plain PyTorch pyramid below on the same
device. The route depends only on (factors, method, sparse, dtype, shape).
On the CPU the same route calls the kernels' plain versions.
``device_pyramid`` takes the route on a tensor with any leading dimensions,
so a batch of K cutouts (``pyramid_batched``, ``parallel.ChunkExecutor``)
is the launches of one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from . import cuda_pooling
from .cuda_pooling import SIGNED_VIEW

Factor3 = Tuple[int, int, int]


def method_for_layer(layer_type: str, method="auto") -> str:
  """``method`` accepts the string names, a DownsampleMethods enum member,
  or its integer value."""
  from ..types import DownsampleMethods

  method = DownsampleMethods.to_name(method)
  if method != "auto":
    return method
  return "mode" if layer_type == "segmentation" else "average"


# ---------------------------------------------------------------------------
# plain PyTorch pyramid on (c, z, y, x) tensors


def _pad_to_multiple(x: torch.Tensor, f: Factor3) -> torch.Tensor:
  """Edge-replicate z, y and x up to multiples of the factor."""
  if x.dtype in SIGNED_VIEW:
    return _pad_to_multiple(x.view(SIGNED_VIEW[x.dtype]), f).view(x.dtype)
  for dim, fd in zip((1, 2, 3), (f[2], f[1], f[0])):
    n = x.shape[dim]
    pad = (-n) % fd
    if pad:
      last = x.narrow(dim, n - 1, 1)
      x = torch.cat([x] + [last] * pad, dim=dim)
  return x


def _window_slices(x: torch.Tensor, f: Factor3) -> list:
  """The n = fz*fy*fx strided slices of each pooling window, ordered
  z-major then y then x (position index = dx + fx*(dy + fy*dz))."""
  fx, fy, fz = f
  x = _pad_to_multiple(x, f)
  return [
    x[:, dz::fz, dy::fy, dx::fx]
    for dz in range(fz)
    for dy in range(fy)
    for dx in range(fx)
  ]


def _pool_average(x: torch.Tensor, f: Factor3) -> torch.Tensor:
  vs = _window_slices(x, f)
  n = len(vs)
  # XLA compiles the reference's division by the window size into a
  # product with its float32 reciprocal; the float paths here do the same,
  # so their bits match (exact either way for power-of-two windows)
  inv_n = float(np.float32(1.0 / n))
  if x.dtype.is_floating_point:
    acc = sum(v.to(torch.float32) for v in vs)
    return (acc * inv_n).to(x.dtype)
  if x.element_size() <= 2:
    acc = sum(v.to(torch.int32) for v in vs)
    return torch.div(acc + n // 2, n, rounding_mode="floor").to(x.dtype)
  if n & (n - 1) == 0:
    # power-of-two window on 32-bit integers: the reference sums the
    # unsigned bit patterns exactly (hi/lo 16-bit planes) and returns
    # floor((sum + n/2) / n) as uint32 bits; an int64 sum is the same
    k = n.bit_length() - 1
    acc = sum(v.to(torch.int64) & 0xFFFFFFFF for v in vs) + n // 2
    out = acc >> k
    if x.dtype == torch.uint32:
      return out.to(torch.uint32)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
  # ... and contracts its multiply-add into one fused multiply-add: the
  # float32 product is exact in float64, so one rounding to float32 of the
  # float64 result gives the same bits
  acc = sum(v.to(torch.float32) for v in vs)
  y = (acc.to(torch.float64) * inv_n + 0.5).to(torch.float32)
  return torch.floor(y).to(x.dtype)


def _pool_mode(x: torch.Tensor, f: Factor3, sparse: bool) -> torch.Tensor:
  """Winner = highest occurrence count, ties to the earliest window
  position; sparse ignores zeros unless the whole window is zero."""
  if x.dtype in SIGNED_VIEW:
    return _pool_mode(x.view(SIGNED_VIEW[x.dtype]), f, sparse).view(x.dtype)
  vs = _window_slices(x, f)
  n = len(vs)
  pair = {}
  for i in range(n):
    for j in range(i + 1, n):
      pair[(i, j)] = (vs[i] == vs[j]).to(torch.int32)

  best_score = best_val = None
  for i in range(n):
    counts = 1  # self-match
    for j in range(n):
      if i != j:
        counts = counts + pair[(min(i, j), max(i, j))]
    score = counts * n - i
    if not torch.is_tensor(score):  # a 1-voxel window
      score = torch.full(vs[i].shape, score, dtype=torch.int32, device=x.device)
    if sparse:
      # all-zero windows keep 0: position 0's value is 0 and survives
      score = torch.where(vs[i] == 0, -1, score)
    if best_score is None:
      best_score, best_val = score, vs[i]
    else:
      take = score > best_score
      best_score = torch.where(take, score, best_score)
      best_val = torch.where(take, vs[i], best_val)
  return best_val


# PyTorch implements min/max on neither uint16, uint32 nor uint64: widen
# the first two, and flip the sign bit of the third to order it as int64
_MINMAX_WIDEN = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def _pool_minmax(x: torch.Tensor, f: Factor3, op: str) -> torch.Tensor:
  dtype = x.dtype
  if dtype in _MINMAX_WIDEN:
    x = x.to(_MINMAX_WIDEN[dtype])
  elif dtype == torch.uint64:
    x = x.view(torch.int64) ^ -(2**63)
  vs = _window_slices(x, f)
  acc = vs[0]
  for v in vs[1:]:
    acc = torch.minimum(acc, v) if op == "min" else torch.maximum(acc, v)
  if dtype == torch.uint64:
    return (acc ^ -(2**63)).view(torch.uint64)
  return acc.to(dtype)


def _pool_striding(x: torch.Tensor, f: Factor3) -> torch.Tensor:
  fx, fy, fz = f
  return x[:, ::fz, ::fy, ::fx]


def _pool_once(x: torch.Tensor, f: Factor3, method: str, sparse: bool):
  if method == "mode":
    return _pool_mode(x, f, sparse)
  if method == "average":
    return _pool_average(x, f)
  if method in ("min", "max"):
    return _pool_minmax(x, f, method)
  if method == "striding":
    return _pool_striding(x, f)
  raise ValueError(f"Unknown downsample method: {method}")


def _pyramid_impl(x: torch.Tensor, factors, method: str, sparse: bool):
  outs = []
  for f in factors:
    x = _pool_once(x, f, method, sparse)
    outs.append(x)
  return tuple(outs)


# ---------------------------------------------------------------------------
# routing and the host-facing API: (x, y, z[, c]) numpy in and out


def _normalize_factors(factor, num_mips: int) -> Tuple[Factor3, ...]:
  """One (fx,fy,fz) triple applied every mip, or a per-mip sequence."""
  arr = np.asarray(factor, dtype=np.int64)
  if arr.ndim == 2:
    if len(arr) < num_mips:
      raise ValueError(f"need {num_mips} per-mip factors, got {len(arr)}")
    return tuple(tuple(int(v) for v in f) for f in arr[:num_mips])
  return tuple(tuple(int(v) for v in arr) for _ in range(num_mips))


def _kernel_takes(method: str, sparse: bool, dtype: np.dtype) -> bool:
  if method == "average":
    return dtype.kind in "iu" and dtype.itemsize <= 2
  return method == "mode" and not sparse and dtype.kind in "iu"


def route(factors, method: str, sparse: bool, dtype) -> int:
  """The length of the leading run of factors the 2x2x1 kernels pool (0
  when they take none); the remaining factors run the plain pyramid.
  ``cuda_pooling.pyramid2x2x1`` picks the fused walk or the iterated step
  for the run. ``dtype`` is the pooled data's (after the bool and 64-bit
  average conversions of ``downsample``)."""
  run = 0
  while run < len(factors) and tuple(factors[run]) == (2, 2, 1):
    run += 1
  return run if _kernel_takes(method, sparse, np.dtype(dtype)) else 0


def device_pyramid(x: torch.Tensor, factors, method: str, sparse: bool) -> List[torch.Tensor]:
  """The pyramid of a (..., c, z, y, x) tensor on its device, one tensor
  per mip with the same leading dimensions: ``route``'s leading run of
  2x2x1 factors through ``cuda_pooling.pyramid2x2x1``, the other factors
  through the plain pyramid. A leading batch dimension is one more run of
  planes to the kernels, so K cutouts take the launches of one."""
  dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
  run = route(factors, method, sparse, dtype)
  outs = cuda_pooling.pyramid2x2x1(x, run, method) if run else []
  cur = outs[-1] if outs else x
  lead = cur.shape[:-3]
  flat = cur.reshape((-1,) + cur.shape[-3:])
  for o in _pyramid_impl(flat, factors[run:], method, sparse):
    outs.append(o.reshape(lead + o.shape[1:]))
  return outs


def pyramid_batched(factors, method: str, sparse: bool):
  """The batched pyramid: a function of a (B, c, z, y, x) array or tensor
  that returns the tuple of (B, ...) mips on the port's device, each
  batch item what ``downsample`` gives it alone. The JAX package's
  ``pyramid_batched`` vmaps its pyramid; here the batch is one more
  leading dimension of the same launches (``device_pyramid``)."""
  factors = tuple(tuple(int(v) for v in f) for f in factors)

  def run(x) -> Tuple[torch.Tensor, ...]:
    x = torch.as_tensor(x, device=get_device())
    if x.dim() != 5:
      raise ValueError(f"expected a (B, c, z, y, x) batch, got shape {tuple(x.shape)}")
    return tuple(device_pyramid(x.contiguous(), factors, method, sparse))

  return run


def _work_array(img: np.ndarray, method: str) -> np.ndarray:
  """The (x, y, z, c) array the device pools, as the reference converts it:
  bool as uint8, and 64-bit data through float32 for average."""
  if img.ndim == 3:
    img = img[..., np.newaxis]
  if img.dtype == bool:
    img = img.view(np.uint8)
  if method == "mode" and img.dtype.kind == "f" and img.dtype.itemsize == 8:
    raise ValueError("mode pooling of floating-point data is not supported")
  if method == "average" and img.dtype.itemsize == 8:
    img = img.astype(np.float32)
  return img


def downsample(
  img: np.ndarray,
  factor,
  num_mips: int = 1,
  method: str = "average",
  sparse: bool = False,
  device=None,
) -> List[np.ndarray]:
  """Pool ``img`` (x,y,z[,c]) iteratively; returns one array per mip.

  ``factor`` is one (fx,fy,fz) triple applied every mip, or a per-mip
  sequence of triples. ``device`` defaults to the port's resolved device
  (``igneous_tpu_torch.device``). The results are (x,y,z[,c]) views of
  C-contiguous (c,z,y,x) host arrays, i.e. Fortran-ordered."""
  dev = get_device() if device is None else torch.device(device)
  squeeze = img.ndim == 3
  orig_dtype = img.dtype
  factors = _normalize_factors(factor, num_mips)
  work = _work_array(img, method)

  # an F-ordered cutout's (c,z,y,x) transpose is already C-contiguous: it
  # goes to the device as one copy, and any reordering happens there
  with telemetry.stage("h2d"):
    x = torch.from_numpy(work.transpose(3, 2, 1, 0)).to(dev).contiguous()
  with telemetry.stage("kernel"):
    outs = device_pyramid(x, factors, method, sparse)
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
  with telemetry.stage("d2h"):
    results = []
    for o in outs:
      r = o.contiguous().cpu().numpy().transpose(3, 2, 1, 0)
      r = r.astype(orig_dtype, copy=False)
      results.append(r[..., 0] if squeeze else r)
  return results


def downsample_auto(
  img: np.ndarray,
  factor,
  num_mips: int = 1,
  method: str = "average",
  sparse: bool = False,
) -> List[np.ndarray]:
  """The tasks' entry point: ``downsample`` on the resolved device (the
  port has no host C++ path; on the CPU the kernels' plain versions run)."""
  return downsample(img, factor, num_mips, method=method, sparse=sparse)
