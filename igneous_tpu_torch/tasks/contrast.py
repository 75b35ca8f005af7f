"""Contrast correction tasks: luminance levels, histogram stretch, CLAHE.

Counterpart of ``igneous_tpu/tasks/contrast.py``, with the same
constructor signatures (so payloads serialized by the JAX package run
here) and the same files:

  ``LuminanceLevelsTask``        samples patch columns at the JAX package's
                                 seeded positions and counts each z's 256
                                 bins on the device (one ``bincount`` of
                                 ``dz * 256 + bin`` a column); writes
                                 ``levels/<mip>/<z>`` JSON files;
  ``ContrastNormalizationTask``  the float32 stretch of each z between its
                                 levels' tails, on the device;
  ``CLAHETask``                  the overlap-padded cutout to the device
                                 once, every z plane through one launch of
                                 the ``clahe`` kernel (``ops/clahe.py``;
                                 the JAX package calls OpenCV on the host),
                                 and only the core copied back.

Points of exactness: unsigned bin widths are powers of two, so a bin is a
shift and a mask of the signed view (uint64 values at or above 2^63 bin as
numpy's ``//`` does); signed layers with negative values raise, as numpy's
``bincount`` does. The stretch is ``(plane - low) / max(high - low, 1) *
(maxval - minval) + minval``, one float32 op each (no fused multiply-add),
then round half to even, a clamp to ``[minval, maxval]`` and the cast; the
input goes to float32 as numpy's ``astype`` does (uint64 through the
halving with a sticky bit, so values at or above 2^63 round once).

Stage timers (``telemetry``): download, levels, stretch, clahe, upload.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from ..lib import Bbox, Vec
from ..observability.device import execute_span, transfer_span
from ..ops.clahe import clahe
from ..ops.cuda_clahe import check_dtype
from ..ops.cuda_pooling import SIGNED_VIEW
from ..ops.mesh import labels_on_device
from ..queues.registry import RegisteredTask
from ..storage import CloudFiles
from ..volume import Volume

LEVELS_BINS = 256


def levels_key(mip: int) -> str:
  return f"levels/{mip}"


def _bin_width(dtype) -> int:
  """Histogram bin width covering the full integer dtype range with
  LEVELS_BINS bins (uint8 -> 1, uint16 -> 256, ...)."""
  dtype = np.dtype(dtype)
  if dtype.kind not in "ui":
    raise ValueError(
      f"luminance histograms require an integer layer, got {dtype}"
    )
  return max((np.iinfo(dtype).max + 1) // LEVELS_BINS, 1)


def compute_stretch_bounds(levels: np.ndarray, clip_fraction: float):
  """(low, high) bin indices clipping `clip_fraction` of mass per tail."""
  total = levels.sum()
  if total == 0:
    return 0, LEVELS_BINS - 1
  cdf = np.cumsum(levels) / total
  lower = int(np.searchsorted(cdf, clip_fraction))
  upper = int(np.searchsorted(cdf, 1.0 - clip_fraction))
  upper = min(max(upper, lower + 1), LEVELS_BINS - 1)
  return lower, upper


def _bins(col: torch.Tensor, dtype: np.dtype, width: int) -> torch.Tensor:
  """The bin of each value of ``col`` (the int64 widening of a ``dtype``
  cutout, uint64 as its bits), numpy's ``col // width``."""
  shift = width.bit_length() - 1
  if dtype.kind == "u":
    return (col >> shift) & (LEVELS_BINS - 1)
  if bool((col < 0).any()):
    raise ValueError("luminance histograms of negative values: bincount takes "
                     "no negative bins")
  return col >> shift


def _to_float32(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
  """numpy's ``astype(np.float32)`` of a ``dtype`` cutout on the device
  (uint16/32 arrive widened to int64, uint64 as its int64 bits)."""
  if dtype == np.uint64:
    low = x.to(torch.float32)
    halved = ((x >> 1) & ((1 << 63) - 1)) | (x & 1)
    return torch.where(x < 0, halved.to(torch.float32) * 2, low)
  return x.to(torch.float32)


def _from_float32(x: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
  """numpy's ``astype(dtype)`` of rounded, clamped float32 values."""
  out = getattr(torch, dtype.name)
  if dtype.kind == "f":
    return x.to(out)
  if out in SIGNED_VIEW:
    return x.to(torch.int64).to(SIGNED_VIEW[out]).view(out)
  return x.to(torch.int64).to(out)


class LuminanceLevelsTask(RegisteredTask):
  """Sample a fraction of one z-range's pixels; upload per-z histograms."""

  def __init__(
    self,
    src_path: str,
    levels_path_: Optional[str] = None,
    shape: Sequence[int] = (2048, 2048, 1),
    offset: Sequence[int] = (0, 0, 0),
    mip: int = 0,
    coverage_factor: float = 0.01,
    fill_missing: bool = False,
  ):
    self.src_path = src_path
    self.levels_path_ = levels_path_
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.coverage_factor = float(coverage_factor)
    self.fill_missing = fill_missing

  PATCH = 256  # xy patch edge for sampled downloads

  def execute(self):
    vol = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing,
                 bounded=False)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), vol.bounds
    )
    if bounds.empty():
      return
    cf = CloudFiles(self.levels_path_ or vol.cloudpath)
    width = _bin_width(vol.dtype)
    rng = np.random.default_rng(int(self.offset.z))  # the JAX package's positions

    sx, sy, sz = (int(v) for v in bounds.size3())
    area = sx * sy
    patch = min(self.PATCH, sx, sy)
    n_patches = max(int(np.ceil(area * self.coverage_factor / patch**2)), 1)
    xs = rng.integers(0, max(sx - patch, 0) + 1, size=n_patches)
    ys = rng.integers(0, max(sy - patch, 0) + 1, size=n_patches)

    # each sampled patch is one full z column, binned and counted on the
    # device as it arrives; the counts stay there until the last column
    dev = get_device()
    hists = torch.zeros(sz * LEVELS_BINS, dtype=torch.int64, device=dev)
    zkey = torch.arange(sz, dtype=torch.int64, device=dev).view(sz, 1, 1) * LEVELS_BINS
    n_samples = 0
    for px, py in zip(xs, ys):
      col_box = Bbox(
        bounds.minpt + (int(px), int(py), 0),
        bounds.minpt + (int(px) + patch, int(py) + patch, sz),
      )
      with telemetry.stage("download"):
        col = vol.download(col_box)[..., 0]
      n_samples += col.shape[0] * col.shape[1]
      with telemetry.stage("levels"):
        seg, _ = labels_on_device(col, (0, 0, 0), (0, 0, 0), dev)
        with execute_span("contrast.levels", seg.numel(), seg.numel() * 8, dev,
                          signature=(tuple(seg.shape), str(col.dtype))):
          key = zkey + _bins(seg, col.dtype, width)
          hists += torch.bincount(key.reshape(-1), minlength=sz * LEVELS_BINS)
    with telemetry.stage("levels"), transfer_span("d2h", hists.numel() * 8, dev):
      hists = hists.view(sz, LEVELS_BINS).cpu().numpy()
    with telemetry.stage("upload"):
      for dz in range(sz):
        z = int(bounds.minpt.z) + dz
        cf.put_json(
          f"{levels_key(self.mip)}/{z}",
          {
            "levels": hists[dz].tolist(),
            "bin_width": int(width),
            "patch_size": [patch, patch, 1],
            "num_samples": int(n_samples),
            "coverage_ratio": self.coverage_factor,
          },
        )


class ContrastNormalizationTask(RegisteredTask):
  """Histogram-stretch using the levels files."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    clip_fraction: float = 0.01,
    fill_missing: bool = False,
    translate: Sequence[int] = (0, 0, 0),
    minval: int = 0,
    maxval: int = 255,
    levels_path_: Optional[str] = None,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.clip_fraction = float(clip_fraction)
    self.fill_missing = fill_missing
    self.translate = Vec(*translate)
    self.minval = int(minval)
    self.maxval = int(maxval)
    self.levels_path_ = levels_path_

  def execute(self):
    src = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing,
                 bounded=False)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if bounds.empty():
      return
    with telemetry.stage("download"):
      img = src.download(bounds)
    cf = CloudFiles(self.levels_path_ or src.cloudpath)

    lows, dens = [], []
    for dz in range(img.shape[2]):
      z = int(bounds.minpt.z) + dz
      doc = cf.get_json(f"{levels_key(self.mip)}/{z}")
      if doc is None:
        raise FileNotFoundError(
          f"levels histogram missing for z={z}; run LuminanceLevelsTask first"
        )
      low, high = compute_stretch_bounds(
        np.asarray(doc["levels"]), self.clip_fraction
      )
      width = int(doc.get("bin_width", 1))
      low, high = low * width, high * width
      lows.append(low)
      dens.append(max(high - low, 1))

    dev = get_device()
    with telemetry.stage("stretch"):
      cz = np.ascontiguousarray(img.transpose(3, 2, 1, 0))  # (c, z, y, x)
      kind = cz.dtype
      # uint16/32/64 travel as their signed views and widen on the device
      unsigned = kind.kind == "u" and kind.itemsize > 1
      if unsigned:
        cz = cz.view(f"i{kind.itemsize}")
      with transfer_span("h2d", cz.nbytes, dev):
        x = torch.from_numpy(cz).to(dev)
      with execute_span("contrast.stretch", x.numel(), x.numel() * 5, dev,
                        signature=(tuple(x.shape), str(kind))):
        if unsigned:
          x = x.to(torch.int64)
          if kind.itemsize < 8:
            x &= (1 << (8 * kind.itemsize)) - 1
        x = _to_float32(x, kind)

        def per_z(vals):
          return torch.tensor(vals, dtype=torch.float32, device=dev).view(1, -1, 1, 1)

        def f32(v):
          return torch.tensor(float(v), dtype=torch.float32, device=dev)

        x = (x - per_z(lows)) / per_z(dens)
        x = x * f32(self.maxval - self.minval)
        x = x + f32(self.minval)
        x = torch.round(x).clamp(self.minval, self.maxval)
        out = _from_float32(x, dest.dtype)
      with transfer_span("d2h", out.numel() * out.element_size(), dev):
        out = out.cpu().numpy().transpose(3, 2, 1, 0)
    with telemetry.stage("upload"):
      dest.upload(bounds.translate(self.translate), out)


class CLAHETask(RegisteredTask):
  """Per-z-slice contrast-limited adaptive histogram equalization, each
  slice OpenCV's ``CLAHE::apply`` bit for bit, on the device."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    clip_limit: float = 40.0,
    tile_grid_size=8,
    fill_missing: bool = False,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.clip_limit = float(clip_limit)
    # int or (gx, gy) pair
    if isinstance(tile_grid_size, (list, tuple)):
      self.tile_grid_size = [int(v) for v in tile_grid_size]
    else:
      self.tile_grid_size = [int(tile_grid_size)] * 2
    self.fill_missing = fill_missing

  def execute(self):
    src = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing,
                 bounded=False)
    dest = Volume(self.dest_path, mip=self.mip)
    core = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if core.empty():
      return
    # overlap-pad x/y by one CLAHE tile so tile boundaries don't show at
    # task seams; x by the grid's first entry, y by its second, as the JAX
    # package does
    tile = np.asarray(core.size3()[:2]) // np.asarray(self.tile_grid_size)
    pad = Vec(int(tile[0]), int(tile[1]), 0)
    cutout = Bbox.intersection(
      Bbox(core.minpt - pad, core.maxpt + pad), src.bounds
    )
    with telemetry.stage("download"):
      img = src.download(cutout)[..., 0]
    zyx = np.ascontiguousarray(img.transpose(2, 1, 0))
    check_dtype(getattr(torch, zyx.dtype.name, None))

    dev = get_device()
    lo = core.minpt - cutout.minpt
    hi = core.maxpt - cutout.minpt
    with telemetry.stage("clahe"):
      with transfer_span("h2d", zyx.nbytes, dev):
        planes = torch.from_numpy(zyx).to(dev)
      # (x, y, z): the plane's rows are x and its columns y, as the JAX
      # package hands img[:, :, z] to OpenCV
      out = clahe(planes.permute(2, 1, 0), self.clip_limit, tuple(self.tile_grid_size))
      core_zyx = out.permute(2, 1, 0)[:, int(lo[1]):int(hi[1]), int(lo[0]):int(hi[0])]
      with transfer_span("d2h", core_zyx.numel() * core_zyx.element_size(), dev):
        core_img = core_zyx.contiguous().cpu().numpy().transpose(2, 1, 0)
    with telemetry.stage("upload"):
      dest.upload(core, core_img.astype(dest.dtype, copy=False))
