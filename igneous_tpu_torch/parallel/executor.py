"""Batched execution of per-chunk kernels on the port's device.

Counterpart of ``igneous_tpu/parallel/executor.py``. Chunks are this
domain's batch dimension: a host leases K grid tasks, stacks their
same-shape cutouts into a (K, c, z, y, x) batch and runs the pooling
pyramid once for all K. The JAX package shard_maps that program over a
mesh of TPU cores; the port has one card, so the batch is one more leading
dimension of the same hand-kernel launches (each kernel already takes a
leading run of planes or tiles), and the mesh's ``psum`` of nonzero
voxels is a count on the card.

Not ported: ``make_mesh``, ``ChunkExecutor.run_global``, ``LRUCache`` and
the compile cache (PyTorch runs eagerly and compiles no signatures), and
the power-of-two padding of K (it only bounded the JAX package's compiled
signatures; the outputs are the same without it).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..device import get_device
from ..observability.device import elements_of, execute_span, nbytes_of, transfer_span
from ..ops.cuda_pooling import SIGNED_VIEW
from ..ops.pooling import device_pyramid


def _tree_map(fn, tree):
  """``fn`` over the leaves of a tuple / list / dict nest of arrays."""
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def to_device(a, dev: torch.device) -> torch.Tensor:
  """A numpy array or tensor on ``dev`` (numpy's unsigned 16/32/64-bit
  arrays included)."""
  if isinstance(a, torch.Tensor):
    return a.to(dev)
  return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def to_host(t: torch.Tensor) -> np.ndarray:
  return t.contiguous().cpu().numpy()


def sync(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


class BatchKernelExecutor:
  """Runs a kernel over K same-shape chunks in one call.

  The contract differs from the JAX package's, which vmaps a per-chunk
  function: ``torch.func.vmap`` cannot trace through the ctypes launches of
  the port's hand kernels, so ``kernel`` here takes the WHOLE batch, a
  (K, ...) tensor or a tuple / list / dict nest of them on the device, and
  returns (K, ...) tensors in any such nest. Every launch inside it covers
  all K chunks.

  ``consts`` (model parameters, say): a nest of arrays that is not
  batched, passed as ``kernel(consts, batch)``. Stage it on the device
  once with :meth:`put_consts` so that its host-to-device copy is paid
  per model, not per call; numpy consts given straight to ``__call__``
  are copied at every call.

  ``stage``: the telemetry stage that times the kernel (``infer`` for a
  model's dispatches). ``name``: the device ledger's name for a dispatch
  (default: the kernel function's name), whose h2d, execute and d2h spans
  it records.
  """

  def __init__(self, kernel: Callable, stage: str = "kernel", name: str = None):
    self.kernel = kernel
    self.stage = stage
    self.name = name or getattr(kernel, "__name__", "kernel").lstrip("_")
    self.device = get_device()
    self._consts: Dict = {}

  def put_consts(self, key, consts):
    """Stage ``consts`` on the device once per ``key`` (a stable identity
    such as the model's path); returns the device nest to pass back as
    ``consts=``."""
    if key not in self._consts:
      with telemetry.stage("h2d"), transfer_span("h2d", nbytes_of(consts), self.device):
        self._consts[key] = _tree_map(lambda a: to_device(a, self.device), consts)
    return self._consts[key]

  def __call__(self, batch, consts=None):
    """batch: a nest of (K, ...) arrays or tensors -> the kernel's nest of
    (K, ...) numpy arrays."""
    dev = self.device
    host_consts = consts is not None and not _on_device(consts)
    nbytes = nbytes_of(batch) + (nbytes_of(consts) if host_consts else 0)
    with telemetry.stage("h2d"), transfer_span("h2d", nbytes, dev):
      xs = _tree_map(lambda a: to_device(a, dev), batch)
      if consts is not None:
        consts = _tree_map(lambda a: to_device(a, dev), consts)
    with telemetry.stage(self.stage):
      with execute_span(self.name, elements_of(xs), nbytes_of(xs), dev):
        out = self.kernel(xs) if consts is None else self.kernel(consts, xs)
      sync(dev)
    with telemetry.stage("d2h"), transfer_span("d2h", nbytes_of(out), dev):
      return _tree_map(to_host, out)


def _on_device(tree) -> bool:
  """True when every leaf of a nest is a tensor (staged by ``put_consts``)."""
  if isinstance(tree, dict):
    return all(_on_device(v) for v in tree.values())
  if isinstance(tree, (tuple, list)):
    return all(_on_device(v) for v in tree)
  return isinstance(tree, torch.Tensor)


def join_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
  """(lo, hi) uint32 planes -> the int64 of the same uint64 bits, on the
  tensors' device (the port's mode kernel compares 64-bit words)."""
  if sys.byteorder != "little":  # pragma: no cover
    raise RuntimeError("plane pairs assume a little-endian host")
  pair = torch.stack((lo.view(torch.int32), hi.view(torch.int32)), dim=-1)
  return pair.view(torch.int64).squeeze(-1)


def split_planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """The inverse of ``join_planes``: int64 -> contiguous (lo, hi) uint32."""
  pair = x.contiguous().view(torch.int32).unflatten(-1, (x.shape[-1], 2))
  return (pair[..., 0].contiguous().view(torch.uint32),
          pair[..., 1].contiguous().view(torch.uint32))


class ChunkExecutor:
  """The batched pyramid over (K, c, z, y, x) chunks on the port's device.

  It routes as ``ops.pooling.route`` does for one cutout: the leading run
  of 2x2x1 factors is one ``pyramid2x2x1`` call for all K cutouts (one
  launch while the run fits ``max_fused_levels``), the other factors the
  plain pyramid on the same device.
  """

  def __init__(
    self,
    factors: Sequence[Tuple[int, int, int]] = ((2, 2, 1),),
    method: str = "average",
    sparse: bool = False,
    planes: int = 1,
  ):
    """``planes=2`` takes (lo, hi) uint32 plane pairs, the JAX package's
    uint64 label representation, and returns per-mip plane pairs; the
    pairs are joined into one int64 view on the card and split again
    after the pyramid."""
    self.factors = tuple(tuple(int(v) for v in f) for f in factors)
    self.method = method
    self.sparse = sparse
    self.planes = int(planes)
    if self.planes not in (1, 2):
      raise ValueError("planes must be 1 or 2")
    if self.planes == 2 and method != "mode":
      raise ValueError("plane pairs are only meaningful for mode pooling")
    self.device = get_device()
    self.name = f"pooling.pyramid[{method}]"

  def run(self, x: torch.Tensor):
    """(K, c, z, y, x) tensor on the device -> (per-mip (K, ...) tensors,
    the count of nonzero voxels as a 0-d tensor on the device)."""
    if x.dim() != 5:
      raise ValueError(f"expected a (K, c, z, y, x) batch, got shape {tuple(x.shape)}")
    outs = device_pyramid(x.contiguous(), self.factors, self.method, self.sparse)
    return outs, torch.count_nonzero(x.view(SIGNED_VIEW.get(x.dtype, x.dtype)))

  def __call__(self, batch):
    """batch: a (K, c, z, y, x) array or tensor (planes=1), or a (lo, hi)
    tuple of them (planes=2) -> (per-mip numpy outputs, nonzero voxels).
    The outputs mirror the input's arity: arrays, or (lo, hi) tuples."""
    arrs = batch if isinstance(batch, tuple) else (batch,)
    if len(arrs) != self.planes:
      raise ValueError(f"expected {self.planes} plane(s), got {len(arrs)}")
    with telemetry.stage("h2d"), transfer_span("h2d", nbytes_of(arrs), self.device):
      xs = [to_device(a, self.device) for a in arrs]
    with telemetry.stage("kernel"):
      with execute_span(self.name, elements_of(xs), nbytes_of(xs), self.device,
                        signature=(tuple(xs[0].shape), str(xs[0].dtype), self.factors)):
        x = join_planes(*xs) if self.planes == 2 else xs[0]
        outs, nonzero = self.run(x)
        if self.planes == 2:
          outs = [split_planes(o) for o in outs]
      sync(self.device)
    with telemetry.stage("d2h"), transfer_span("d2h", nbytes_of(outs), self.device):
      if self.planes == 2:
        result = [(to_host(lo), to_host(hi)) for lo, hi in outs]
      else:
        result = [to_host(o) for o in outs]
      return result, int(nonzero)


_CHUNK_EXECUTORS: Dict[tuple, ChunkExecutor] = {}


def cached_chunk_executor(
  factors: Sequence[Tuple[int, int, int]] = ((2, 2, 1),),
  method: str = "average",
  sparse: bool = False,
  planes: int = 1,
) -> ChunkExecutor:
  """One ChunkExecutor per (device, pyramid configuration), shared by
  repeat callers (``batched_downsample`` per batch)."""
  key = (
    str(get_device()), tuple(tuple(int(v) for v in f) for f in factors),
    method, bool(sparse), int(planes),
  )
  if key not in _CHUNK_EXECUTORS:
    _CHUNK_EXECUTORS[key] = ChunkExecutor(
      factors, method=method, sparse=sparse, planes=planes
    )
  return _CHUNK_EXECUTORS[key]
