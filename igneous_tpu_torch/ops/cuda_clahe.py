"""CLAHE of a stack of 8- or 16-bit planes: the CUDA kernel's binding and
OpenCV's geometry.

The JAX package equalises each z plane of a ``CLAHETask`` on the host with
OpenCV (``cv2.createCLAHE(...).apply``, ``igneous_tpu/tasks/contrast.py``);
the card's machine has no OpenCV, so the port computes the same function
with a kernel of its own, ``clahe`` in ``csrc/clahe.cu``: one block (8-bit)
or one cluster of two blocks (16-bit) per (plane, tile) builds the tile's
LUT, and a blend pass reads the planes 16 bytes a thread and blends four
LUTs per voxel, a batch of planes at a time. ``ops/clahe.py`` holds the
entry point and the plain PyTorch version; this module holds what both
share (``geometry``: OpenCV's padding, tiles, clip limit and float32
scales), the blend's weight tables and the launch.

``launch`` takes CUDA tensors only and raises otherwise; ``LAUNCHES``
counts its launches (one a call: the kernels of ``csrc/clahe.cu`` go out
from one C entry point), one per launch and nowhere else. The device
ledger's execute span goes around each launch, under the kernel's name.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..observability.device import execute_span
from . import _build

LAUNCHES = {"clahe": 0}

# a launch's LUTs take at most this many bytes, or one plane's when that is
# more (a uint16 plane's LUTs at grid 64 take 512 MiB, as in OpenCV): the
# planes go through the kernels in batches that fit
LUT_BYTES = 256 << 20
# planes a batch at most: a batch's planes are the kernels' grid y
MAX_BATCH = 65535
# LUT entries of a plane at most (the kernels index them with int32)
MAX_PLANE_LUT = 2**31 - 1

# histogram bins of each plane type (OpenCV's histSize), and its code in
# csrc/clahe.cu
BINS = {torch.uint8: 256, torch.uint16: 65536}
_CODES = {torch.uint8: 0, torch.uint16: 1}


class Geometry(NamedTuple):
  """What OpenCV's ``CLAHE::apply`` derives from a plane's size, the tile
  grid and the clip limit, with the same arithmetic."""

  rows: int
  cols: int
  gy: int  # tiles across the rows
  gx: int  # tiles across the columns
  pad_rows: int  # rows of BORDER_REFLECT_101 added at the bottom
  pad_cols: int  # columns added at the right
  th: int  # a tile's rows of the padded plane
  tw: int  # a tile's columns
  bins: int
  limit: int  # clip limit in counts; 0: no clip
  lut_scale: np.float32  # (bins - 1) / (th * tw), a float32 division
  inv_th: np.float32  # 1 / th, float32
  inv_tw: np.float32  # 1 / tw, float32


def tile_grid(grid) -> Tuple[int, int]:
  """(gx, gy) of an int or an OpenCV ``tileGridSize`` pair: gx tiles across
  the columns, gy across the rows."""
  if isinstance(grid, (tuple, list)):
    gx, gy = (int(v) for v in grid)
  else:
    gx = gy = int(grid)
  if gx < 1 or gy < 1:
    raise ValueError(f"the tile grid must be positive: {grid!r}")
  return gx, gy


def geometry(rows: int, cols: int, grid, clip_limit: float, bins: int) -> Geometry:
  """OpenCV's geometry of one plane: the plane is used as it is when both
  extents divide by the grid; otherwise the bottom gains ``gy - rows % gy``
  rows and the right ``gx - cols % gx`` columns (a whole extra ``gy`` when
  the rows divide and the columns do not, and so on)."""
  gx, gy = tile_grid(grid)
  if rows % gy == 0 and cols % gx == 0:
    pad_rows = pad_cols = 0
  else:
    pad_rows, pad_cols = gy - rows % gy, gx - cols % gx
  th, tw = (rows + pad_rows) // gy, (cols + pad_cols) // gx
  total = th * tw
  limit = 0
  if clip_limit > 0.0:
    limit = max(int(float(clip_limit) * total / bins), 1)
  return Geometry(
    rows, cols, gy, gx, pad_rows, pad_cols, th, tw, bins, limit,
    np.float32(bins - 1) / np.float32(total),
    np.float32(1.0) / np.float32(th), np.float32(1.0) / np.float32(tw),
  )


def reflect101(p: np.ndarray, n: int) -> np.ndarray:
  """OpenCV's ``borderInterpolate`` for ``BORDER_REFLECT_101``
  (dcb|abcd|cba) of indices ``p`` into ``n``, looping for a border wider
  than the plane."""
  p = np.asarray(p, dtype=np.int64).copy()
  if n == 1:
    return np.zeros_like(p)
  out = (p < 0) | (p >= n)
  while out.any():
    p = np.where(p < 0, -p, np.where(p >= n, 2 * n - 2 - p, p))
    out = (p < 0) | (p >= n)
  return p


def check_dtype(dtype) -> None:
  """OpenCV's CLAHE takes 8- and 16-bit unsigned planes only."""
  if dtype not in BINS:
    raise TypeError(f"CLAHE takes uint8 or uint16 planes, not {dtype}")


_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    lib = _build.load("clahe")
    lib.igt_clahe.argtypes = [
      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.igt_clahe.restype = ctypes.c_int
    lib.igt_error_string.argtypes = [ctypes.c_int]
    lib.igt_error_string.restype = ctypes.c_char_p
    _LIB = lib
  return _LIB


def weight_table(n: int, inv: np.float32, tiles: int) -> np.ndarray:
  """The blend's weights along one axis of ``n`` rows (or columns), as
  OpenCV's interpolation computes them per voxel, once per index: an
  (n, 4) int32 array of (t1, t2, a, a1), t1 and t2 the lower and upper
  tile (clamped to the grid), a and a1 = 1 - a the float32 weights of t2
  and t1 as their bits. ``inv`` is 1 / th (or 1 / tw) in float32."""
  f = np.arange(n, dtype=np.float32) * np.float32(inv) - np.float32(0.5)
  t1 = np.floor(f)
  a = f - t1
  a1 = np.float32(1.0) - a
  t1 = t1.astype(np.int32)
  t2 = np.minimum(t1 + 1, tiles - 1)
  return np.stack([np.maximum(t1, 0), t2, a.view(np.int32), a1.view(np.int32)], axis=1)


@functools.lru_cache(maxsize=32)
def _device_table(n: int, inv: np.float32, tiles: int, device: torch.device) -> torch.Tensor:
  return torch.from_numpy(weight_table(n, inv, tiles)).to(device)


def launch_plan(planes: int, g: Geometry, itemsize: int) -> Tuple[int, int]:
  """(batch, lut_blocks) of a launch over ``planes`` planes: the planes a
  batch, whose LUTs fit ``LUT_BYTES`` (one plane's when more), and the
  blocks of a batch's LUT pass, one a (plane, tile) for 8-bit planes and
  a cluster of two for 16-bit ones."""
  one_plane = g.gy * g.gx * g.bins * itemsize
  batch = min(planes, max(1, LUT_BYTES // one_plane), MAX_BATCH)
  return batch, batch * g.gy * g.gx * (1 if g.bins <= 256 else 2)


def buffers(planes: int, g: Geometry, itemsize: int) -> Dict[str, int]:
  """The bytes a launch over ``planes`` planes takes on the card besides
  its input and output: the LUTs of a batch and the two weight tables
  (cached per geometry). There is no scratch."""
  batch, _ = launch_plan(planes, g, itemsize)
  return {"lut": batch * g.gy * g.gx * g.bins * itemsize,
          "row_table": 16 * g.rows, "column_table": 16 * g.cols}


def launch(planes: torch.Tensor, clip_limit: float, grid) -> torch.Tensor:
  """CLAHE of each plane of a (P, C, R) C-contiguous CUDA tensor (a
  Volume's (z, y, x) cutout: plane rows are x, columns y), bit for bit
  OpenCV's; returns a new (P, C, R) tensor. Besides the output it takes
  ``buffers``: at most ``LUT_BYTES`` of LUTs (one plane's, when that is
  more) and the weight tables."""
  check_dtype(planes.dtype)
  if planes.device.type != "cuda":
    raise ValueError(f"the clahe kernel takes CUDA tensors, not {planes.device}")
  if planes.dim() != 3 or not planes.is_contiguous():
    raise ValueError(
      f"the clahe kernel takes C-contiguous (planes, cols, rows) tensors, got "
      f"shape {tuple(planes.shape)}"
    )
  P, C, R = planes.shape
  bins = BINS[planes.dtype]
  g = geometry(R, C, grid, clip_limit, bins)
  if g.gy * g.gx * bins > MAX_PLANE_LUT:
    raise ValueError(f"a {g.gx}x{g.gy} grid of {bins}-entry LUTs is too large for the kernel")
  out = torch.empty_like(planes)
  if out.numel() == 0:
    return out
  batch, _ = launch_plan(P, g, planes.element_size())
  lut = torch.empty((batch, g.gy, g.gx, bins), dtype=planes.dtype, device=planes.device)
  rows = _device_table(R, g.inv_th, g.gy, planes.device)
  cols = _device_table(C, g.inv_tw, g.gx, planes.device)
  lib = _lib()
  nbytes = 2 * planes.numel() * planes.element_size()
  with torch.cuda.device(planes.device):
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with execute_span("clahe", planes.numel(), nbytes, planes.device,
                      signature=(tuple(planes.shape), str(planes.dtype), g.gx, g.gy)):
      rc = lib.igt_clahe(
        _CODES[planes.dtype], planes.data_ptr(), out.data_ptr(), lut.data_ptr(),
        rows.data_ptr(), cols.data_ptr(), P, batch, R, C, g.gy, g.gx, g.th, g.tw,
        g.limit, float(g.lut_scale), stream,
      )
      if rc != 0:
        msg = lib.igt_error_string(rc).decode()
        raise RuntimeError(f"clahe kernel failed: CUDA error {rc} ({msg})")
  LAUNCHES["clahe"] += 1
  return out
