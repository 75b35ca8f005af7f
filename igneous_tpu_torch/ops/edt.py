"""Multilabel anisotropic Euclidean distance transform on the port's device.

The port's counterpart of ``igneous_tpu/ops/edt.py``'s ``edt``, with the
semantics of the JAX package's host path (``IGNEOUS_EDT_BACKEND=native``,
``igneous_tpu/native/csrc/edt.cpp``), which that package takes for every
CPU skeleton task: for every nonzero voxel, the anisotropic distance to the
nearest voxel centre of a DIFFERENT label (background reads 0), bit for bit.

Three axis passes, x (edge term only), then y, then z, each one launch of
``cuda_edt.edt_pass`` over the (z, y, x) labels: the CUDA kernel of
``csrc/edt.cu`` on the card, its plain PyTorch version on the CPU. Labels
are compared by raw 32- or 64-bit equality: ids of 32 bits or fewer travel
as int32, 64-bit ids as int64 (uint64 bits, ids at or above 2^63
included), and 0 stays background whatever the sign of the others.

``edt_batch`` runs K same-shape cutouts through the same three launches
(the lines of all K in each pass); ``parallel.paged.paged_edt`` pads a
ragged fleet to one shape first. Not ported (ROADMAP.md): the
``IGNEOUS_EDT_BACKEND`` / ``IGNEOUS_EDT_LINE_BLOCK`` knobs and the JAX
package's float32 device variant.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import numpy as np
import torch

from ..device import get_device
from .cuda_edt import edt_pass


def squared_edt(lab: torch.Tensor, anisotropy: Sequence[float]) -> torch.Tensor:
  """(z, y, x) contiguous int32 or int64 labels, or a (K, z, y, x) batch
  of them -> the squared distances, float32 in the same layout, before the
  background is cleared. ``anisotropy`` is (wx, wy, wz). Each pass is one
  launch over the lines of every item: the x and y passes on the
  (K*z, y, x) view, the z pass along axis 1 of the (K, z, y*x) view, so
  that no line runs from one item into the next."""
  wx, wy, wz = (float(a) for a in anisotropy)
  batch = lab if lab.dim() == 4 else lab[None]
  K, Z, Y, X = batch.shape
  a = torch.empty(batch.shape, dtype=torch.float32, device=lab.device)
  b = torch.empty_like(a)
  rows = lambda t: t.view(K * Z, Y, X)  # noqa: E731
  cols = lambda t: t.view(K, Z, Y * X)  # noqa: E731
  edt_pass(rows(batch), rows(a), rows(a), 2, wx, True)
  edt_pass(rows(batch), rows(a), rows(b), 1, wy, False)
  edt_pass(cols(batch), cols(b), cols(a), 1, wz, False)
  return a if lab.dim() == 4 else a[0]


def distance_field(
  lab: torch.Tensor, anisotropy: Sequence[float], black_border: bool = False
) -> torch.Tensor:
  """(z, y, x) int32 or int64 labels on the device, or a (K, z, y, x)
  batch of them -> float32 distances in the same layout: the square root
  of ``squared_edt`` (float32, as ``np.sqrt`` of the host path: correctly
  rounded), exactly 0 on background. ``black_border`` treats the outside
  of each item as background. On the CPU the root is taken in double and
  rounded once to float32 (the same value), since PyTorch's vectorised
  float32 root on the CPU may be one unit in the last place off."""
  work = lab
  if black_border:
    work = torch.zeros(
      lab.shape[:-3] + tuple(s + 2 for s in lab.shape[-3:]),
      dtype=lab.dtype, device=lab.device,
    )
    work[..., 1:-1, 1:-1, 1:-1] = lab
  sq = squared_edt(work.contiguous(), anisotropy)
  del work
  if black_border:
    sq = sq[..., 1:-1, 1:-1, 1:-1]
  out = torch.sqrt(sq.double()).float() if sq.device.type == "cpu" else torch.sqrt(sq)
  return out.masked_fill_(lab == 0, 0.0)


def host_labels(labels: np.ndarray) -> np.ndarray:
  """Any integer (or bool) labels -> int32 or int64 of the same bits where
  they are 32 or 64 bits wide (narrower ids widen), as the host path
  compares them."""
  if labels.dtype.itemsize <= 4:
    lab = labels if labels.dtype.itemsize == 4 else labels.astype(np.int32)
    return lab.view(np.int32)
  return labels.view(np.int64)


def edt(
  labels: np.ndarray,
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  black_border: bool = False,
) -> np.ndarray:
  """labels: (x, y, z) integers -> float32 distances, same shape, computed
  on the port's device. ``black_border`` treats the array boundary as
  background (kimimaro uses this so skeletons stay inside the cutout)."""
  if labels.ndim != 3:
    raise ValueError("labels must be 3d")
  lab = host_labels(np.asarray(labels))
  zyx = np.ascontiguousarray(lab.transpose(2, 1, 0))
  t = torch.from_numpy(zyx).to(get_device())
  out = distance_field(t, anisotropy, black_border)
  return out.cpu().numpy().transpose(2, 1, 0)


def batch_edt_executor(anisotropy, black_border: bool = False):
  """The ``BatchKernelExecutor`` of ``distance_field`` over a (K, z, y, x)
  labels batch: three ``edt_pass`` launches for all K."""
  from ..parallel.executor import BatchKernelExecutor

  anis = tuple(float(a) for a in anisotropy)
  return BatchKernelExecutor(
    partial(distance_field, anisotropy=anis, black_border=black_border)
  )


def edt_batch(
  labels_batch: np.ndarray,
  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
  black_border: bool = False,
  executor=None,
):
  """Batched EDT: (K, x, y, z) labels -> list of K float32 distance
  fields, each bit for bit ``edt`` of that cutout alone, from the three
  launches of one (``squared_edt`` on the batch)."""
  labels_batch = np.asarray(labels_batch)
  if labels_batch.ndim != 4:
    raise ValueError("labels_batch must be (K, x, y, z)")
  if executor is None:
    executor = batch_edt_executor(anisotropy, black_border)
  lab = host_labels(labels_batch)
  field = executor(np.ascontiguousarray(lab.transpose(0, 3, 2, 1)))
  return [f.transpose(2, 1, 0) for f in field]
