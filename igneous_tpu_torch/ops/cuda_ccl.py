"""Block-local CCL resolve of (T, tz, ty, tx) tiles: a CUDA kernel and its
plain PyTorch version.

Counterpart of ``igneous_tpu/ops/pallas_ccl.py``. Its Pallas kernel
``tile_resolve`` becomes the hand-written CUDA kernel of ``csrc/ccl.cu``,
with the same contract: labt is (T, tz, ty, tx) int32 dense labels (0 is
background); every foreground voxel gets the local flat index
(z*ty*tx + y*tx + x) of the minimum voxel of its tile-component, where two
voxels connect iff their labels are equal and nonzero and they are
neighbours under 6/18/26-connectivity inside the tile; a background voxel
keeps its own index (the caller masks it).

The wrapper takes its plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. ``LAUNCHES``
counts kernel launches, one per launch and nowhere else. The device
ledger's execute span (``observability.device``) goes around each launch
and each plain call, under the kernel's name.
"""

from __future__ import annotations

import ctypes

import torch

from ..observability.device import execute_span
from . import _build

LAUNCHES = {"tile_resolve": 0}

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SMEM_PER_VOXEL = 8  # the kernel keeps an int32 label and an int32 parent
# tile shapes with a kernel instance compiled for them (csrc/ccl.cu,
# dispatch): the CUDA default and the other shapes of chip_smoke.py's sweep
FIXED_TILES = ((16, 16, 32), (8, 16, 64), (8, 16, 32))
_BIG = torch.iinfo(torch.int32).max


def neighbor_offsets(connectivity: int):
  """cc3d-style neighbourhoods as (dz, dy, dx): 6 = faces, 18 = +edges,
  26 = +corners (the order of ``igneous_tpu/ops/ccl.py:neighbor_offsets``)."""
  if connectivity not in (6, 18, 26):
    raise ValueError(f"connectivity must be 6, 18 or 26: {connectivity}")
  offs = []
  for dz in (-1, 0, 1):
    for dy in (-1, 0, 1):
      for dx in (-1, 0, 1):
        if (dx, dy, dz) == (0, 0, 0):
          continue
        degree = abs(dx) + abs(dy) + abs(dz)
        if connectivity == 6 and degree > 1:
          continue
        if connectivity == 18 and degree > 2:
          continue
        offs.append((dz, dy, dx))
  return offs


def fits_shared_memory(tile) -> bool:
  """True when one (tz, ty, tx) tile fits one block's shared memory."""
  tz, ty, tx = tile
  return SMEM_PER_VOXEL * tz * ty * tx <= SMEM_LIMIT


def fixed_instance(tile, *ptrs: int) -> bool:
  """True when the kernel instance compiled for ``tile`` runs: the tile is
  one of ``FIXED_TILES`` and every pointer is 16-byte aligned (its loads
  and stores move 16 bytes a thread). Any other tile or pointer takes the
  instance with runtime extents."""
  return tuple(tile) in FIXED_TILES and all(p % 16 == 0 for p in ptrs)


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the yardstick on the card)


def _coord(shape, axis: int, device) -> torch.Tensor:
  """The index along ``axis``, shaped to broadcast against ``shape``."""
  view = [1] * len(shape)
  view[axis] = shape[axis]
  return torch.arange(shape[axis], dtype=torch.int32, device=device).view(view)


def _seg_cummin_doubling(L, lab, axis: int, reverse: bool):
  """Segmented cummin of L along ``axis`` within runs of equal labels, by
  log-step doubling (``pallas_ccl._seg_cummin_doubling``)."""
  n = L.shape[axis]
  d = -1 if reverse else 1
  coord = _coord(L.shape, axis, L.device)
  edge = coord >= 1 if not reverse else coord <= n - 2
  ok = edge & (torch.roll(lab, d, axis) == lab)
  v = L
  s = 1
  while s < n:
    vs = torch.roll(v, d * s, axis)
    oks = torch.roll(ok, d * s, axis)
    v = torch.where(ok, torch.minimum(v, vs), v)
    ok = ok & oks
    s *= 2
  return v


def _neighbor_min(L, lab, connectivity: int):
  """min of L over each voxel and its same-label neighbours, wrapped planes
  invalidated (the neighbour-min of ``pallas_ccl._resolve_kernel``)."""
  m = L
  for off in neighbor_offsets(connectivity):
    nb_L, nb_lab, valid = L, lab, None
    for axis, dd in zip((1, 2, 3), off):
      if dd == 0:
        continue
      nb_L = torch.roll(nb_L, dd, axis)
      nb_lab = torch.roll(nb_lab, dd, axis)
      coord = _coord(lab.shape, axis, lab.device)
      ok = coord != (0 if dd == 1 else lab.shape[axis] - 1)
      valid = ok if valid is None else (valid & ok)
    same = valid & (nb_lab == lab)
    m = torch.minimum(m, torch.where(same, nb_L, _BIG))
  return m


def tile_resolve_plain(labt: torch.Tensor, connectivity: int = 6) -> torch.Tensor:
  """The Pallas kernel's own algorithm in PyTorch: each round runs the
  doubling segmented cummin along every axis in both directions, then the
  neighbour-min; a tile leaves the loop at its own fixpoint (the active
  tiles are gathered each round), and the loop ends when no tile changed."""
  _check(labt, connectivity)
  T, tz, ty, tx = labt.shape
  L = torch.arange(tz * ty * tx, dtype=torch.int32, device=labt.device)
  L = L.view(1, tz, ty, tx).expand(T, tz, ty, tx).contiguous()
  active = torch.arange(T, device=labt.device)
  while active.numel():
    lab = labt[active]
    Lc = L[active]
    Lp = Lc
    for axis in (1, 2, 3):
      Lp = torch.minimum(
        _seg_cummin_doubling(Lp, lab, axis, False),
        _seg_cummin_doubling(Lp, lab, axis, True),
      )
    Lp = torch.minimum(Lp, _neighbor_min(Lp, lab, connectivity))
    Lp = torch.where(lab != 0, torch.minimum(Lc, Lp), Lc)
    changed = (Lp != Lc).flatten(1).any(dim=1)
    L[active] = Lp
    active = active[changed]
  return L


# ---------------------------------------------------------------------------
# kernel wrapper


def _check(labt: torch.Tensor, connectivity: int) -> None:
  neighbor_offsets(connectivity)
  if labt.dtype != torch.int32:
    raise TypeError(f"tile_resolve takes int32 dense labels, not {labt.dtype}")
  if labt.dim() != 4:
    raise ValueError(f"expected (T, tz, ty, tx) tiles, got shape {tuple(labt.shape)}")


_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    lib = _build.load("ccl")
    lib.igt_tile_resolve.argtypes = [
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.igt_tile_resolve.restype = ctypes.c_int
    lib.igt_error_string.argtypes = [ctypes.c_int]
    lib.igt_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def tile_resolve(labt: torch.Tensor, connectivity: int = 6) -> torch.Tensor:
  """(T, tz, ty, tx) int32 tiles -> (T, tz, ty, tx) int32 local roots."""
  span = execute_span(
    "tile_resolve", labt.numel(), 8 * labt.numel(), labt.device,
    signature=(tuple(labt.shape), connectivity),
  )
  if labt.device.type == "cpu":
    with span:
      return tile_resolve_plain(labt, connectivity)
  _check(labt, connectivity)
  if labt.device.type != "cuda":
    raise ValueError(f"tile_resolve takes CPU or CUDA tensors, not {labt.device}")
  if not labt.is_contiguous():
    raise ValueError("tile_resolve takes C-contiguous (T, tz, ty, tx) tiles")
  T, tz, ty, tx = labt.shape
  if not fits_shared_memory((tz, ty, tx)):
    raise ValueError(
      f"a ({tz}, {ty}, {tx}) tile needs {SMEM_PER_VOXEL * tz * ty * tx} bytes "
      f"of shared memory, more than the {SMEM_LIMIT} one block may use; "
      "choose a smaller IGNEOUS_CCL_TILE"
    )
  out = torch.empty_like(labt)
  if out.numel() == 0:
    return out
  lib = _lib()
  with torch.cuda.device(labt.device):
    stream = torch.cuda.current_stream(labt.device).cuda_stream
    fixed = fixed_instance((tz, ty, tx), labt.data_ptr(), out.data_ptr())
    with span:
      rc = lib.igt_tile_resolve(
        labt.data_ptr(), out.data_ptr(), T, tz, ty, tx, connectivity, int(fixed),
        stream,
      )
      if rc != 0:
        msg = lib.igt_error_string(rc).decode()
        raise RuntimeError(f"tile_resolve kernel failed: CUDA error {rc} ({msg})")
  LAUNCHES["tile_resolve"] += 1
  return out
