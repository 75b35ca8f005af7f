"""Multi-host pods over ``torch.distributed``: one lease per pod, one
program per batch.

Counterpart of ``igneous_tpu/parallel/multihost.py``. Across pods the
queue and the object store coordinate, as in the JAX package; within one
pod lease, ``torch.distributed`` joins the pod's processes (ranks) into
one group. Each rank runs the batched pyramid on its own slice of the
lease (``ChunkExecutor.run_global``, ``PagedGlobalRunner``) on its own
device, and the one cross-rank value, the lease's count of nonzero
voxels, is an all-reduce (the JAX package's ``psum``).

Usage on each rank of a pod (the CPU tests and ``chip_smoke.py`` use the
same calls):

    from igneous_tpu_torch.parallel import multihost
    multihost.initialize()          # IGNEOUS_COORDINATOR/NUM_PROCESSES/PROCESS_ID
    pod = multihost.pod_mesh()      # this rank's view of the pod
    mine, per = multihost.lease_partition(n_chunks)
    batch = multihost.from_process_local(pod, download(mine), per)
    outs, nonzero = ChunkExecutor(...).run_global(batch)
    for shard in outs[0].addressable_shards: ...   # this rank's rows

**The backend rule.** ``nccl`` when the port's device is CUDA and every
rank on this host has a card of its own, i.e. the host's ranks
(``LOCAL_WORLD_SIZE``, as torchrun sets it; else the world size: ranks
started by hand on one host) are no more than its cards; the rank then
runs on ``cuda:{LOCAL_RANK}`` (else ``cuda:{rank}``). ``gloo`` otherwise:
on the CPU, and when ranks share a card (NCCL refuses two ranks on one
device), in which case each rank keeps the device it resolved and its
kernels still run there; only the collective rides gloo, on a host copy
of the count. The rule reads the configuration; it never catches a
failed ``init_process_group`` to try the other backend.

Counterparts of the JAX functions: ``initialize`` is
``init_process_group`` (``IGNEOUS_COORDINATOR`` as ``host:port`` or
``tcp://host:port``; with none of the three knobs set, ``env://``, which
is torchrun's counterpart of JAX's auto-detection on a pod), idempotent,
with the JAX package's error on a second call with other arguments;
``cpu_collectives_available`` is ``torch.distributed.is_gloo_available``
(JAX's ``_enable_cpu_collectives`` has no counterpart: gloo needs no
switch); ``pod_mesh`` returns a :class:`Pod`; the partitions are the JAX
package's arithmetic on the pod's counts (:func:`_topology`); a global
batch is a :class:`GlobalBatch` whose ``addressable_shards`` hold this
rank's rows, one shard a row, so callers read outputs as they read the
JAX package's. A rank addresses only its own rows: there is no global
gather.
"""

from __future__ import annotations

import atexit
import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import knobs
from ..device import get_device, set_device
from ..ops.cuda_pooling import SIGNED_VIEW

# init_process_group's rendezvous and collective timeout: a rank whose
# peer never arrives fails instead of hanging
TIMEOUT_SEC = 240.0


def _dist():
  import torch.distributed as dist

  return dist


def _local_ranks(rank: int, world: int) -> Tuple[int, int]:
  """(this rank's index on its host, the host's rank count): torchrun's
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, else every rank on this host."""
  local_rank = os.environ.get("LOCAL_RANK")
  local_world = os.environ.get("LOCAL_WORLD_SIZE")
  return (int(local_rank) if local_rank else rank,
          int(local_world) if local_world else world)


def backend_for(device: torch.device, local_world: int) -> str:
  """The module docstring's rule: ``nccl`` for CUDA ranks with a card
  each, ``gloo`` otherwise."""
  if device.type == "cuda" and local_world <= torch.cuda.device_count():
    return "nccl"
  return "gloo"


def initialize(
  coordinator_address: Optional[str] = None,
  num_processes: Optional[int] = None,
  process_id: Optional[int] = None,
) -> None:
  """``init_process_group`` with the JAX package's env fallbacks;
  idempotent. Pins this rank's device first (``cuda:{local rank}`` under
  ``nccl``), and registers :func:`shutdown` at exit, so a failed rank
  leaves the group instead of hanging its peers."""
  kw = {}
  addr = (
    coordinator_address if coordinator_address is not None
    else knobs.get_str("IGNEOUS_COORDINATOR")
  )
  if addr:
    kw["coordinator_address"] = addr
  nproc = (
    num_processes if num_processes is not None
    else knobs.get_int("IGNEOUS_NUM_PROCESSES")
  )
  if nproc is not None:
    kw["num_processes"] = int(nproc)
  pid = (
    process_id if process_id is not None
    else knobs.get_int("IGNEOUS_PROCESS_ID")
  )
  if pid is not None:
    kw["process_id"] = int(pid)
  prior = getattr(initialize, "_args", None)
  if prior is not None:
    if prior != kw:
      raise RuntimeError(
        f"multihost.initialize already ran with {prior}; re-initializing "
        f"with {kw} is not supported (the process group is process-global)"
      )
    return
  dist = _dist()
  if not addr:
    init_method = "env://"
  else:
    init_method = addr if "://" in addr else f"tcp://{addr}"
  world = int(nproc) if nproc is not None else None
  rank = int(pid) if pid is not None else None
  if init_method == "env://":
    world = world if world is not None else int(os.environ.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
  if world is None or rank is None:
    raise ValueError(
      "a tcp:// rendezvous needs the world size and this rank "
      "(IGNEOUS_NUM_PROCESSES, IGNEOUS_PROCESS_ID)"
    )
  device = get_device()
  local_rank, local_world = _local_ranks(rank, world)
  backend = backend_for(device, local_world)
  if backend == "nccl":
    device = set_device(f"cuda:{local_rank}")
    torch.cuda.set_device(device)
  dist.init_process_group(
    backend, init_method=init_method, world_size=world, rank=rank,
    timeout=datetime.timedelta(seconds=TIMEOUT_SEC),
  )
  initialize._args = kw
  atexit.register(shutdown)


def shutdown() -> None:
  """Leave the process group (``destroy_process_group``); a later
  :func:`initialize` may join another."""
  dist = _dist()
  if dist.is_available() and dist.is_initialized():
    dist.destroy_process_group()
  initialize._args = None


def cpu_collectives_available() -> bool:
  """Does this PyTorch build have gloo, the CPU collectives a pod of CPU
  ranks (or of ranks sharing one card) all-reduces over?"""
  dist = _dist()
  return bool(dist.is_available() and dist.is_gloo_available())


def _joined():
  dist = _dist()
  return dist if dist.is_available() and dist.is_initialized() else None


def _topology() -> Tuple[int, int, int]:
  """(global device count, process count, this process's index): every
  rank has one device, so the device count is the world size. Outside a
  pod, one process of one device. The partition functions read the pod
  only through here."""
  dist = _joined()
  if dist is None:
    return 1, 1, 0
  world = dist.get_world_size()
  return world, world, dist.get_rank()


@dataclass(frozen=True)
class Pod:
  """This rank's view of the pod: the JAX mesh's ``axis_names``, the
  world size, this rank, its device, and the global device count (the
  world size times a rank's one device)."""

  axis_names: Tuple[str, ...]
  world_size: int
  rank: int
  device: torch.device
  device_count: int


def pod_mesh(axis: str = "chunks") -> Pod:
  """The pod's one-axis "mesh" over every rank's device."""
  ndev, nproc, pid = _topology()
  return Pod((axis,), nproc, pid, get_device(), ndev)


def lease_partition(n_chunks: int):
  """(this process's chunk indices, per-process slot count).

  The JAX package's arithmetic: the lease is padded to a multiple of the
  global device count, every process owns ``per`` slots, and indices past
  ``n_chunks`` are the zero-pad slots ``from_process_local`` fills, so
  every process passes the same local shape.
  """
  ndev, nproc, pid = _topology()
  canon = -(-max(n_chunks, 1) // ndev) * ndev
  per = canon // nproc
  start = pid * per
  return [i for i in range(start, start + per) if i < n_chunks], per


def page_partition(n_pages: int, weights=None):
  """Contiguous per-process page ranges ``(start, stop, per)`` of a paged
  pod dispatch, as the JAX package splits them: this process owns global
  pages ``[start, stop)`` and pads its pages to ``per`` slots (a multiple
  of a process's devices, the same everywhere). ``weights``: optional
  per-process throughput weights (:func:`throughput_weights`), which give
  a slow host a proportionally shorter range."""
  ndev, nproc, pid = _topology()
  ldev = max(ndev // nproc, 1)
  if weights is None:
    w = np.ones(nproc, dtype=np.float64)
  else:
    if len(weights) != nproc:
      raise ValueError(f"need {nproc} weights, got {len(weights)}")
    w = np.maximum(np.asarray(weights, dtype=np.float64), 1e-9)
  w = w / w.sum()
  bounds = np.floor(np.cumsum(w) * n_pages + 0.5).astype(np.int64)
  bounds[-1] = n_pages
  starts = np.concatenate([[0], bounds[:-1]])
  lens = np.maximum(bounds - starts, 0)
  per = int(-(-max(int(lens.max()), 1) // ldev) * ldev)
  return int(starts[pid]), int(bounds[pid]), per


def throughput_weights(
  journal_path: str,
  workers,
  window_sec: float = 600.0,
  floor: float = 0.25,
):
  """Per-worker weights for :func:`page_partition` from the journal's
  task spans (each worker's tasks per busy second), aligned to
  ``workers`` (the process-ordered worker ids, the same list on every
  process). None when the journal has no usable rates. Workers the
  journal has not seen get the fleet median; measured rates are clamped
  to ``floor`` times the median."""
  from ..observability import fleet

  try:
    rates = fleet.worker_rates(
      fleet.load_effective(journal_path), window_sec=window_sec
    )
  except Exception:
    return None
  known = sorted(rates[w] for w in workers if w in rates)
  if not known:
    return None
  median = float(known[len(known) // 2])
  if median <= 0:
    return None
  return [
    max(float(rates.get(w, median)), floor * median) for w in workers
  ]


@dataclass(frozen=True)
class Shard:
  """One row of a global batch this rank addresses: ``index[0]`` its
  global row, ``data`` the (1, ...) tensor on the rank's device."""

  index: Tuple[slice, ...]
  data: torch.Tensor


@dataclass(frozen=True)
class GlobalBatch:
  """A batch sharded by rows over the pod: this rank's ``per`` rows
  (``data``, on its device) at global rows ``[offset, offset + per)`` of
  ``shape``."""

  data: torch.Tensor
  offset: int
  shape: Tuple[int, ...]

  @property
  def addressable_shards(self) -> List[Shard]:
    rest = tuple(slice(0, n) for n in self.shape[1:])
    return [
      Shard((slice(self.offset + i, self.offset + i + 1),) + rest,
            self.data[i:i + 1])
      for i in range(self.data.shape[0])
    ]

  def like(self, data: torch.Tensor) -> "GlobalBatch":
    """A batch of per-row outputs ``data`` on the same rows."""
    return GlobalBatch(data, self.offset,
                       (self.shape[0],) + tuple(data.shape[1:]))


def from_process_local(mesh: Pod, local_batch, per: int) -> GlobalBatch:
  """The global batch from this process's chunks: its
  ``lease_partition`` (or ``page_partition``) slice, up to ``per`` rows,
  zero-padded to ``per`` so every process contributes the same local
  shape, and copied to this rank's device. No data crosses ranks."""
  if isinstance(local_batch, torch.Tensor):
    rows = local_batch
  else:
    rows = torch.from_numpy(np.ascontiguousarray(np.asarray(local_batch)))
  if rows.shape[0] > per:
    raise ValueError(
      f"local batch has {rows.shape[0]} chunks but this process "
      f"owns only {per} slots (see lease_partition)"
    )
  dtype = rows.dtype
  # pads and copies on the signed view of unsigned types (the card has
  # no concatenation of them)
  rows = rows.contiguous().view(SIGNED_VIEW.get(dtype, dtype)).to(mesh.device)
  if rows.shape[0] < per:
    pad = torch.zeros((per - rows.shape[0],) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    rows = torch.cat([rows, pad])
  return GlobalBatch(rows.contiguous().view(dtype), mesh.rank * per,
                     (per * mesh.world_size,) + tuple(rows.shape[1:]))


def all_reduce_count(count: torch.Tensor) -> int:
  """The sum over the pod of a 0-d integer count (the JAX package's
  ``psum``): the CUDA tensor itself under ``nccl``, a CPU int64 under
  ``gloo``; the count unchanged outside a pod."""
  dist = _joined()
  if dist is None:
    return int(count)
  if dist.get_backend() == "nccl":
    t = count.to(torch.int64).reshape(1)
  else:
    t = count.to(device="cpu", dtype=torch.int64).reshape(1)
  dist.all_reduce(t, op=dist.ReduceOp.SUM)
  return int(t.item())


def same_rows(batches: Sequence[GlobalBatch]) -> Tuple[GlobalBatch, ...]:
  """``batches`` (a plane pair, pages and their extents) as a tuple;
  raises unless they cover the same global rows."""
  batches = tuple(batches)
  if len({(b.offset, b.shape[0]) for b in batches}) > 1:
    raise ValueError("plane batches must cover the same global rows")
  return batches
