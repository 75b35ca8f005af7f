"""Contrast-limited adaptive histogram equalisation, OpenCV's
``CLAHE::apply`` bit for bit, on the port's device.

``clahe(img, clip_limit, tile_grid)`` equalises each plane of a (rows,
cols, planes) tensor of uint8 or uint16: on a CUDA tensor one launch of the
``clahe`` kernel (``cuda_clahe.launch``, ``csrc/clahe.cu``) does all the
planes, on a CPU tensor ``clahe_plain`` runs. Any other type raises, as
OpenCV does. ``tile_grid`` is an int or OpenCV's ``tileGridSize`` pair
``(gx, gy)``: gx tiles across the columns, gy across the rows. A
``CLAHETask`` hands it a Volume's (x, y, z) cutout, so the rows are x and
the columns y, as the JAX package hands ``img[:, :, z]`` to OpenCV.

OpenCV's arithmetic, which both versions follow:
  - padding: a plane whose rows divide by gy and columns by gx is used as
    it is; otherwise the bottom gains ``gy - rows % gy`` rows and the right
    ``gx - cols % gx`` columns of ``BORDER_REFLECT_101`` (a whole extra gy
    when the rows divide and the columns do not). The LUTs come from the
    padded plane, the blend runs over the plane;
  - each tile's histogram (256 bins for uint8, 65536 for uint16) is clipped
    at ``limit = max(int(clip * th * tw / bins), 1)`` (no clip when clip is
    0); the clipped count goes ``clipped // bins`` to every bin, and its
    remainder one a bin to bins 0, step, 2 step, ... with ``step =
    max(bins // remainder, 1)``;
  - ``lut = rint(float32(cumsum) * float32((bins - 1) / (th * tw)))``;
  - each voxel blends the LUTs of its four nearest tiles at its value in
    float32, ``(L11 xa1 + L12 xa) ya1 + (L21 xa1 + L22 xa) ya``, with no
    fused multiply-add, and rounds half to even.
"""

from __future__ import annotations

import torch

from ..observability.device import execute_span
from . import cuda_clahe
from .cuda_clahe import check_dtype, geometry, reflect101


def _f32(v) -> torch.Tensor:
  return torch.tensor(float(v), dtype=torch.float32)


def _weights(n: int, inv: torch.Tensor, tiles: int):
  """Per row (or column) index: the lower and upper tile and the two
  float32 weights, as OpenCV's interpolation computes them."""
  f = torch.arange(n, dtype=torch.int32).to(torch.float32) * inv - _f32(0.5)
  t1 = torch.floor(f).to(torch.int64)
  a = f - t1.to(torch.float32)
  a1 = _f32(1.0) - a
  t2 = torch.clamp(t1 + 1, max=tiles - 1)
  return t1.clamp(min=0), t2, a, a1


def _plane_lut(plane: torch.Tensor, g) -> torch.Tensor:
  """The (gy, gx, bins) int64 LUTs of one (rows, cols) int64 plane."""
  ridx = torch.from_numpy(reflect101(range(g.rows + g.pad_rows), g.rows)).to(plane.device)
  cidx = torch.from_numpy(reflect101(range(g.cols + g.pad_cols), g.cols)).to(plane.device)
  padded = plane[ridx][:, cidx]
  tiles = padded.reshape(g.gy, g.th, g.gx, g.tw).permute(0, 2, 1, 3).reshape(g.gy * g.gx, -1)
  T, H = g.gy * g.gx, g.bins
  key = torch.arange(T, device=plane.device)[:, None] * H + tiles
  hist = torch.bincount(key.reshape(-1), minlength=T * H).reshape(T, H)
  if g.limit > 0:
    clipped = (hist - g.limit).clamp(min=0).sum(1, keepdim=True)
    hist = hist.clamp(max=g.limit)
    batch = torch.div(clipped, H, rounding_mode="floor")
    residual = clipped - batch * H
    step = torch.div(H, residual.clamp(min=1), rounding_mode="floor").clamp(min=1)
    i = torch.arange(H, device=plane.device)[None]
    below = torch.div(i, step, rounding_mode="floor") < residual
    extra = (residual > 0) & (i % step == 0) & below
    hist = hist + batch + extra.to(hist.dtype)
  cum = hist.cumsum(1).to(torch.float32)
  lut = torch.round(cum * _f32(g.lut_scale).to(plane.device))
  return lut.clamp(0, H - 1).to(torch.int64).reshape(g.gy, g.gx, H)


def clahe_plain(img: torch.Tensor, clip_limit: float = 40.0, tile_grid=8) -> torch.Tensor:
  """CLAHE of each plane of a (rows, cols, planes) uint8 or uint16 tensor in
  plain PyTorch, one plane after another; returns a new (rows, cols,
  planes) tensor laid out as a Fortran-ordered array (planes outermost)."""
  check_dtype(img.dtype)
  if img.dim() != 3:
    raise ValueError(f"expected a (rows, cols, planes) tensor, got shape {tuple(img.shape)}")
  R, C, P = img.shape
  g = geometry(R, C, tile_grid, clip_limit, cuda_clahe.BINS[img.dtype])
  out = torch.empty((P, C, R), dtype=img.dtype, device=img.device).permute(2, 1, 0)
  if img.numel() == 0:
    return out
  dev = img.device
  ty1, ty2, ya, ya1 = (t.to(dev)[:, None] for t in _weights(R, _f32(g.inv_th), g.gy))
  tx1, tx2, xa, xa1 = (t.to(dev)[None] for t in _weights(C, _f32(g.inv_tw), g.gx))
  H = g.bins
  for p in range(P):
    plane = img[:, :, p]
    if img.dtype == torch.uint16:
      plane = plane.view(torch.int16).to(torch.int64) & 0xFFFF
    else:
      plane = plane.to(torch.int64)
    lut = _plane_lut(plane, g).to(torch.float32).reshape(-1)

    def at(ty, tx):
      return lut[(ty * g.gx + tx) * H + plane]

    top = at(ty1, tx1) * xa1 + at(ty1, tx2) * xa
    bottom = at(ty2, tx1) * xa1 + at(ty2, tx2) * xa
    res = torch.round(top * ya1 + bottom * ya).clamp(0, H - 1).to(torch.int64)
    if img.dtype == torch.uint16:
      out[:, :, p] = res.to(torch.int16).view(torch.uint16)
    else:
      out[:, :, p] = res.to(torch.uint8)
  return out


def clahe(img: torch.Tensor, clip_limit: float = 40.0, tile_grid=8) -> torch.Tensor:
  """CLAHE of each plane of a (rows, cols, planes) uint8 or uint16 tensor,
  bit for bit OpenCV's: one ``clahe`` kernel launch for every plane on a
  CUDA tensor, ``clahe_plain`` on a CPU tensor. Returns a (rows, cols,
  planes) tensor laid out as a Fortran-ordered array."""
  check_dtype(img.dtype)
  if img.dim() != 3:
    raise ValueError(f"expected a (rows, cols, planes) tensor, got shape {tuple(img.shape)}")
  if img.device.type == "cpu":
    with execute_span("clahe.plain", img.numel(), 2 * img.numel() * img.element_size(),
                      img.device, signature=(tuple(img.shape), str(img.dtype))):
      return clahe_plain(img, clip_limit, tile_grid)
  planes = img.permute(2, 1, 0).contiguous()
  return cuda_clahe.launch(planes, clip_limit, tile_grid).permute(2, 1, 0)
